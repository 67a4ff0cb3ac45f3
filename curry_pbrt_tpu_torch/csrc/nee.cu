// Next-event estimation (one-light MIS NEE) for Hopper (sm_90a): the two
// halves of models/integrators.uniform_sample_one_light around its shadow
// and MIS traversals, one lane a thread.
//
//   nee_sample_kernel  light pick, the area triangle's point sample and
//                      solid-angle pdf, the shading frame, the lane's own
//                      family's lobes at the light direction (f, pdf,
//                      present), ONE lobe sample of that family for the MIS
//                      leg, the power heuristic; writes the shadow ray, the
//                      MIS ray and a small carry.
//   (the caller's K2 shadow walk and slim K1 MIS walk, unchanged)
//   nee_finish_kernel  the occlusion bit and the MIS hit → the area light's
//                      emission and pdf at that hit → (ld_light + ld_bsdf)
//                      × n_lights, the (N, 3) result the plain path returns.
//
// Replaces no TPU kernel: the JAX package's uniform_sample_one_light
// (curry_pbrt_tpu/models/integrators.py) is jnp, which XLA fuses. In the
// port it was some hundreds of full-width PyTorch ops a bounce: every (N, 3)
// temporary written to device memory and read back, every non-delta
// family's whole lobe stack evaluated and sampled for every lane and then
// selected by material, and every op run over lanes whose result the
// caller discards.
//
// What bounds it on an H100: bytes. A live lane reads its hit (p, n,
// p_error: 36 B), wo (12 B), five sampler values (20 B), its material id
// and its own lobe constants (12–40 B, a broadcast constant read once per
// warp), and writes two rays with their t_max (56 B) and a carry (37 B);
// the finish reads the carry, the two walks' results and the MIS ray back
// and writes 12 B: ≲ 300 B a lane, ~0.38 ms for a 4,194,304-lane bounce at
// 3.35 TB/s. The design answers that with one thread a lane and no
// temporaries in device memory, each lane evaluating and sampling only its
// own family's lobes (a table from material id to family slot; each slot's
// lobe tensors passed by pointer and strides, so an expanded constant is
// read with stride 0, never copied), and lanes whose result is discarded
// (mask unset) skip all the math: t_max 0 rays, a zero result.
//
// Numerics: shading.cuh's note; its device code (the frame, Fresnel,
// Trowbridge-Reitz, the lobes) is shared with the path continuation
// (shade.cu). Lobe kinds: lambert_r and ggx_r (dielectric Fresnel, or none);
// integrators.uniform_sample_one_light sends any other plan to the plain
// path.

#include "shading.cuh"

namespace curry {
namespace {

constexpr int THREADS = 256;
constexpr unsigned char LIGHT_OK = 1, BSDF_OK = 2;  // carry flags

struct FamArgs {
    int n_lobes, pad;
    LobeArgs lobe[MAX_LOBES];
};

struct SampleArgs {
    int n, n_fams;
    Consts k;
    const unsigned char* mask;  // (n,) bool: lanes whose result is consumed
    const int* mat_ids;         // (n,) int32, -1 on a miss
    const int* fam_slot;        // (n_mats + 1,) int32 by mat id + 1: family slot, -1 none
    Rows3 p, nrm, perr, wo;
    Rows1 u_pick, u_light0, u_light1, u_nee0, u_nee1;
    const float* light_L;  // (L, 3) contiguous, and the light table's
    const float* tri_p0;   // area-triangle vertices (L, 3) and areas (L,)
    const float* tri_p1;
    const float* tri_p2;
    const float* area;
    float* vis_o;  // (n, 3) shadow ray
    float* vis_d;
    float* vis_t;  // (n,)
    float* o2;     // (n, 3) MIS ray
    float* wi2;
    float* t2;     // (n,)
    float* carry;  // (n, 8): ld_light (3), f2 (3), f2_pdf, cos2
    int* light_idx;        // (n,)
    unsigned char* flags;  // (n,) LIGHT_OK | BSDF_OK
    FamArgs fam[MAX_FAMS];
};

struct FinishArgs {
    int n;
    Consts k;
    const unsigned char* flags;
    const unsigned char* occluded;  // (n,) bool: the shadow walk's
    const float* hit_t;             // (n,) the MIS walk's t and prim
    const int* hit_prim;
    const int* prim_light;  // (P,) int32, -1 for a non-emitter
    Rows3 p;
    const float* o2;
    const float* wi2;
    const float* carry;
    const int* light_idx;
    const float* light_L;
    const float* tri_p0;
    const float* tri_p1;
    const float* tri_p2;
    const float* area;
    float* out;  // (n, 3)
};

// ops/math.power_heuristic
__device__ __forceinline__ float power_heuristic(float f, float g) {
    const float f2 = f * f;
    const float den = f2 + g * g;
    return den == 0.0f ? 0.0f : f2 / (den == 0.0f ? 1.0f : den);
}

// --- the two halves

__device__ void sample_lane(const SampleArgs& a, int i) {
    if (!a.mask[i]) {  // the caller discards this lane: t_max 0 rays, no result
        const V zero = {0.0f, 0.0f, 0.0f};
        store3(a.vis_o, i, zero);
        store3(a.vis_d, i, zero);
        store3(a.o2, i, zero);
        store3(a.wi2, i, zero);
        a.vis_t[i] = 0.0f;
        a.t2[i] = 0.0f;
        a.flags[i] = 0;
        return;
    }
    const Consts& k = a.k;
    const V p = load3(a.p, i), n = load3(a.nrm, i), perr = load3(a.perr, i), wo = load3(a.wo, i);

    // pick one light uniformly
    const int li = min((int)(load1(a.u_pick, i) * (float)k.n_lights), k.n_lights - 1);

    // sample_li, TYPE_AREA_TRI: uniform area sample → solid-angle pdf
    const V L = row3(a.light_L, li);
    const V p0 = row3(a.tri_p0, li), p1 = row3(a.tri_p1, li), p2 = row3(a.tri_p2, li);
    const float su0 = sqrtf(load1(a.u_light0, i));
    const float b0 = 1.0f - su0;
    const float b1 = load1(a.u_light1, i) * su0;
    const float b2 = 1.0f - b0 - b1;
    const V sp = p0 * b0 + p1 * b1 + p2 * b2;
    const V sn = normalize(cross(p0 - p2, p1 - p2));
    const V serr = (vabs(p0 * b0) + vabs(p1 * b1) + vabs(p2 * b2)) * k.g6;
    const float area = __ldg(a.area + li);
    const V wvec = sp - p;
    const float dist2 = dot(wvec, wvec);
    const V wi = normalize(wvec);
    const float denom = -dot(wi, sn);
    float li_pdf = rdiv(1.0f, clamp_min(area, PYF(1e-20))) * dist2 / (denom == 0.0f ? 1.0f : denom);
    if (denom == 0.0f || dist2 == 0.0f || is_nan(li_pdf) || is_inf(li_pdf)) li_pdf = 0.0f;
    const bool li_present = dist2 > 0.0f;

    // the shadow ray: both endpoints offset (VisibilityTester::new)
    const V o_b = offset_point(p, n, perr, sp - p);
    const V to_b = offset_point(sp, sn, serr, o_b - sp);
    store3(a.vis_o, i, o_b);
    store3(a.vis_d, i, to_b - o_b);
    a.vis_t[i] = k.shadow_t;

    // the shading frame, local +z = n
    V fx, fy;
    shading_frame(n, fx, fy);
    const V wi_l = to_local(wi, fx, fy, n);
    const V wo_l = to_local(wo, fx, fy, n);

    const int slot = __ldg(a.fam_slot + __ldg(a.mat_ids + i) + 1);
    V f = {0.0f, 0.0f, 0.0f}, f2 = {0.0f, 0.0f, 0.0f}, wi2_l = {0.0f, 0.0f, 0.0f};
    float f_pdf = 0.0f, f2_pdf = 0.0f;
    bool f_pres = false, f2_pres = false;
    if (slot >= 0) {
        const FamArgs& fam = a.fam[slot];
        // bsdf_eval_pdf over the family's reflect lobes (all its lobes)
        V f_r = {0.0f, 0.0f, 0.0f};
        float pdf_r = 0.0f;
        bool pres_r = false;
        for (int j = 0; j < fam.n_lobes; ++j) {
            const LobeArgs& l = fam.lobe[j];
            bool lp;
            const V lf = lobe_f(l, lobe_vals(l, i), wo_l, wi_l, k, lp);
            f_r = f_r + (lp ? lf : V{0.0f, 0.0f, 0.0f});
            pdf_r = pdf_r + (lp ? fabsf(wi_l.z) * k.inv_pi : 0.0f);
            pres_r = pres_r || lp;
        }
        pdf_r = pdf_r * (1.0f / (float)fam.n_lobes);
        const bool reflect = wo_l.z * wi_l.z > 0.0f;
        f = reflect ? f_r : V{0.0f, 0.0f, 0.0f};
        f_pdf = reflect ? pdf_r : 0.0f;
        f_pres = reflect && pres_r;

        // bsdf_sample_nondelta: one lobe, chosen uniformly
        const float fu = load1(a.u_nee0, i) * (float)fam.n_lobes;
        const int j = min((int)fu, fam.n_lobes - 1);
        const LobeArgs& l = fam.lobe[j];
        wi2_l = lobe_sample(l, lobe_vals(l, i), wo_l, fu - floorf(fu), load1(a.u_nee1, i), k, f2,
                            f2_pdf, f2_pres);
        f2_pdf = f2_pdf * (1.0f / (float)fam.n_lobes);
    }

    // the light strategy, before its occlusion test
    const float cos_term = fabsf(dot(n, wi));
    const float weight = power_heuristic(li_pdf, f_pdf);
    const V ld_light = L * f * (cos_term * weight / (li_pdf == 0.0f ? 1.0f : li_pdf));

    // the BSDF strategy's ray (to_world, then the offset origin)
    const V wi2 = to_world(wi2_l, fx, fy, n);
    store3(a.o2, i, offset_point(p, n, perr, wi2));
    store3(a.wi2, i, wi2);
    a.t2[i] = k.fmax;

    float* c = a.carry + 8 * (long long)i;
    c[0] = ld_light.x;
    c[1] = ld_light.y;
    c[2] = ld_light.z;
    c[3] = f2.x;
    c[4] = f2.y;
    c[5] = f2.z;
    c[6] = f2_pdf;
    c[7] = fabsf(dot(n, wi2));
    a.light_idx[i] = li;
    a.flags[i] = (li_present && li_pdf != 0.0f && f_pres && f_pdf != 0.0f ? LIGHT_OK : 0) |
                 (f2_pres && f2_pdf != 0.0f ? BSDF_OK : 0);
}

__device__ void finish_lane(const FinishArgs& a, int i) {
    const unsigned char fl = a.flags[i];
    const float nl = (float)a.k.n_lights;
    V ld_light = {0.0f, 0.0f, 0.0f}, ld_bsdf = {0.0f, 0.0f, 0.0f};
    const float* c = a.carry + 8 * (long long)i;
    if ((fl & LIGHT_OK) && !a.occluded[i]) ld_light = V{c[0], c[1], c[2]};
    if (fl & BSDF_OK) {
        const int prim = a.hit_prim[i];
        const int li = a.light_idx[i];
        const int hl = prim >= 0 ? __ldg(a.prim_light + prim) : -1;
        if (hl >= 0 && hl == li) {  // the MIS ray hit the chosen light
            const V o2 = row3(a.o2, i), wi2 = row3(a.wi2, i);
            const V hp = o2 + wi2 * a.hit_t[i];
            // le_pdf, TYPE_AREA_TRI: the light's own triangle gives the normal
            const V p0 = row3(a.tri_p0, li), p1 = row3(a.tri_p1, li), p2 = row3(a.tri_p2, li);
            const V hn = normalize(cross(p0 - p2, p1 - p2));
            const V dvec = load3(a.p, i) - hp;
            const float dist2 = dot(dvec, dvec);
            const float dist = sqrtf(clamp_min(dist2, PYF(1e-20)));
            const V dn = {dvec.x / dist, dvec.y / dist, dvec.z / dist};
            const float denom = fabsf(dot(dn, hn)) * __ldg(a.area + li);
            float pdf = dist2 / (denom == 0.0f ? 1.0f : denom);
            if (denom == 0.0f || is_nan(pdf) || is_inf(pdf)) pdf = 0.0f;
            if (pdf != 0.0f) {
                const float f2_pdf = c[6];
                const float s =
                    c[7] * power_heuristic(f2_pdf, pdf) / (f2_pdf == 0.0f ? 1.0f : f2_pdf);
                ld_bsdf = row3(a.light_L, li) * V{c[3], c[4], c[5]} * s;
            }
        }
    }
    store3(a.out, i, (ld_light + ld_bsdf) * nl);
}

__global__ void __launch_bounds__(THREADS) nee_sample_kernel(const SampleArgs a) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < a.n) sample_lane(a, i);
}

__global__ void __launch_bounds__(THREADS) nee_finish_kernel(const FinishArgs a) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < a.n) finish_lane(a, i);
}

}  // namespace
}  // namespace curry

// Plain C interface for ctypes: the argument structs are host memory laid
// out as above (ops/kernels/nee.py mirrors them; the two size functions let
// it check); their pointers are device pointers. The launch goes on
// `stream` and does not synchronise. Returns cudaGetLastError().
extern "C" int curry_nee_sample_args_size() { return (int)sizeof(curry::SampleArgs); }
extern "C" int curry_nee_finish_args_size() { return (int)sizeof(curry::FinishArgs); }

extern "C" int curry_nee_sample(const void* args, void* stream) {
    const curry::SampleArgs& a = *static_cast<const curry::SampleArgs*>(args);
    if (a.n < 0 || a.n_fams < 0 || a.n_fams > curry::MAX_FAMS || a.k.n_lights < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (a.n == 0) return static_cast<int>(cudaSuccess);
    const int blocks = (a.n + curry::THREADS - 1) / curry::THREADS;
    curry::nee_sample_kernel<<<blocks, curry::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int curry_nee_finish(const void* args, void* stream) {
    const curry::FinishArgs& a = *static_cast<const curry::FinishArgs*>(args);
    if (a.n < 0 || a.k.n_lights < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (a.n == 0) return static_cast<int>(cudaSuccess);
    const int blocks = (a.n + curry::THREADS - 1) / curry::THREADS;
    curry::nee_finish_kernel<<<blocks, curry::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

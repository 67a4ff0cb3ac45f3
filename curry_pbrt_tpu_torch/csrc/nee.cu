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
// Numerics: built like every csrc kernel (-fmad=false, IEEE division and
// square root), and written op for op in the plain path's order: each
// three-term dot product as its products summed left to right, `c / x`
// as PyTorch computes it (reciprocal(x) · c), `x / c` for a host scalar as
// x · (1/c) in float32 (PyTorch's division by a CPU scalar), clamps that
// pass NaN through, the same where-guards and the same NaN / inf scrubs.
// Python float constants enter as float(double), as PyTorch rounds them;
// numpy float32 constants come from the wrapper. Lobe kinds: lambert_r and
// ggx_r (dielectric Fresnel, or none); integrators.uniform_sample_one_light
// sends any other plan to the plain path.

#include <cuda_runtime.h>
#include <math.h>

namespace curry {
namespace {

constexpr int THREADS = 256;
constexpr int MAX_FAMS = 8;   // non-delta families of a plan
constexpr int MAX_LOBES = 4;  // non-delta lobes of a family
constexpr int LAMBERT_R = 0, GGX_R = 1;  // lobe kinds (ops/kernels/nee.py KINDS)
constexpr unsigned char LIGHT_OK = 1, BSDF_OK = 2;  // carry flags

#define PYF(x) ((float)(x))  // a Python float literal, as PyTorch rounds it

// An (N, 3) float32 view: row i's component c at p[i*s0 + c*s1].
struct Rows3 {
    const float* p;
    int s0, s1;
};
// An (N,) float32 view: row i at p[i*s0] (s0 = 0: one value for every row).
struct Rows1 {
    const float* p;
    int s0, pad;
};

struct LobeArgs {
    int kind, fresnel_noop;
    Rows3 albedo;
    Rows1 alpha_x, alpha_y, eta_a, eta_b;  // ggx_r only
};

struct FamArgs {
    int n_lobes, pad;
    LobeArgs lobe[MAX_LOBES];
};

struct Consts {
    float pi, inv_pi, g6, shadow_t, fmax;
    int n_lights;
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

struct V {
    float x, y, z;
};

__device__ __forceinline__ V operator+(V a, V b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V operator-(V a, V b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V operator-(V a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V operator*(V a, V b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V operator*(V a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V vabs(V a) { return {fabsf(a.x), fabsf(a.y), fabsf(a.z)}; }

__device__ __forceinline__ float dot(V a, V b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V cross(V a, V b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ bool is_nan(float x) { return x != x; }
__device__ __forceinline__ bool is_inf(float x) { return fabsf(x) == __int_as_float(0x7f800000); }

// torch.clamp: NaN passes through, else fmax / fmin.
__device__ __forceinline__ float clamp_min(float x, float lo) { return is_nan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp_max(float x, float hi) { return is_nan(x) ? x : fminf(x, hi); }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
    return is_nan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// `c / x` for a tensor x: PyTorch's reciprocal(x) · c.
__device__ __forceinline__ float rdiv(float c, float x) { return (1.0f / x) * c; }

__device__ __forceinline__ float safe_sqrt(float x) { return x <= 0.0f ? 0.0f : sqrtf(x); }

__device__ __forceinline__ V normalize(V v) {
    const float l2 = dot(v, v);
    return v * rsqrtf(l2 == 0.0f ? 1.0f : l2);
}

__device__ __forceinline__ V load3(const Rows3& r, int i) {
    const float* q = r.p + (long long)i * r.s0;
    return {__ldg(q), __ldg(q + r.s1), __ldg(q + 2 * r.s1)};
}
__device__ __forceinline__ float load1(const Rows1& r, int i) {
    return __ldg(r.p + (long long)i * r.s0);
}
__device__ __forceinline__ V row3(const float* t, int j) {
    return {__ldg(t + 3 * j), __ldg(t + 3 * j + 1), __ldg(t + 3 * j + 2)};
}
__device__ __forceinline__ void store3(float* t, int i, V v) {
    t[3 * (long long)i] = v.x;
    t[3 * (long long)i + 1] = v.y;
    t[3 * (long long)i + 2] = v.z;
}

// ops/intersect.offset_point_by_error
__device__ __forceinline__ V offset_point(V p, V n, V perr, V w) {
    const float d = dot(vabs(n), perr);
    const V off = n * d;
    return p + (dot(w, n) < 0.0f ? -off : off);
}

// ops/math.power_heuristic
__device__ __forceinline__ float power_heuristic(float f, float g) {
    const float f2 = f * f;
    const float den = f2 + g * g;
    return den == 0.0f ? 0.0f : f2 / (den == 0.0f ? 1.0f : den);
}

// --- local-frame trigonometry (ops/math), z the normal

__device__ __forceinline__ float sin2_theta(V w) { return clamp_min(1.0f - w.z * w.z, 0.0f); }
__device__ __forceinline__ float sin_theta(V w) { return safe_sqrt(sin2_theta(w)); }
__device__ __forceinline__ float cos_phi(V w) {
    const float st = sin_theta(w);
    return st == 0.0f ? 1.0f : clamp(w.x / (st == 0.0f ? 1.0f : st), -1.0f, 1.0f);
}
__device__ __forceinline__ float sin_phi(V w) {
    const float st = sin_theta(w);
    return st == 0.0f ? 0.0f : clamp(w.y / (st == 0.0f ? 1.0f : st), -1.0f, 1.0f);
}

// --- Fresnel and Trowbridge-Reitz (ops/bsdf)

__device__ __forceinline__ float ratio(float num, float den) {
    return den == 0.0f ? __int_as_float(0x7fc00000) : num / (den == 0.0f ? 1.0f : den);
}

__device__ float fresnel_dielectric(float cos_i, float eta_i, float eta_t) {
    const float ei = cos_i > 0.0f ? eta_i : eta_t;
    const float et = cos_i > 0.0f ? eta_t : eta_i;
    const float ci = fabsf(cos_i);
    const float si = safe_sqrt(1.0f - ci * ci);
    const float st = si * ei / et;
    const float ct = safe_sqrt(1.0f - st * st);
    const float r_par = ratio(et * ci - ei * ct, et * ci + ei * ct);
    const float r_perp = ratio(ei * ci - et * ct, ei * ci + et * ct);
    const float fr = PYF(0.5) * (r_par * r_par + r_perp * r_perp);
    return st >= 1.0f ? 1.0f : fr;
}

__device__ float tr_d(V wh, float ax, float ay, float pi) {
    const float c2 = wh.z * wh.z;
    float t2 = sin2_theta(wh) / c2;
    const bool bad = is_nan(t2) || is_inf(t2);
    t2 = bad ? 0.0f : t2;
    const float c4 = c2 * c2;
    const float cp = cos_phi(wh), sp = sin_phi(wh);
    const float e = (cp * cp / (ax * ax) + sp * sp / (ay * ay)) * t2;
    const float d = rdiv(1.0f, pi * ax * ay * clamp_min(c4, PYF(1e-20)) * (1.0f + e) * (1.0f + e));
    return bad ? 0.0f : d;
}

__device__ float tr_lambda(V w, float ax, float ay) {
    float abs_tan = fabsf(sin_theta(w) / w.z);
    const bool bad = is_nan(abs_tan) || is_inf(abs_tan);
    abs_tan = bad ? 0.0f : abs_tan;
    const float cp = cos_phi(w), sp = sin_phi(w);
    const float alpha = sqrtf(cp * cp * ax * ax + sp * sp * ay * ay);
    const float at = alpha * abs_tan;
    const float lam = (sqrtf(1.0f + at * at) + -1.0f) * PYF(0.5);
    return bad ? 0.0f : lam;
}

// Visible-normal sampling (ops/bsdf.tr_sample_wh) → wh, and its pdf.
__device__ V tr_sample_wh(V wo, float ux, float uy, float ax, float ay, float pi, float& pdf) {
    const bool flip = wo.z < 0.0f;
    const V wi = flip ? -wo : wo;
    const V wi_str = normalize(V{ax * wi.x, ay * wi.y, wi.z});
    const float cti = wi_str.z;

    // near-normal incidence branch
    const float r_n = sqrtf(ux / clamp_min(1.0f - ux, PYF(1e-12)));
    const float phi_n = (2.0f * pi) * uy;
    const float sx_n = r_n * cosf(phi_n);
    const float sy_n = r_n * sinf(phi_n);

    // general branch
    const float st = safe_sqrt(1.0f - cti * cti);
    const float tan_t = st / (cti == 0.0f ? 1.0f : cti);
    const float a = rdiv(1.0f, tan_t == 0.0f ? 1.0f : tan_t);
    const float g1 = rdiv(2.0f, 1.0f + sqrtf(1.0f + rdiv(1.0f, clamp_min(a * a, PYF(1e-20)))));
    const float A = 2.0f * ux / clamp_min(g1, PYF(1e-12)) - 1.0f;
    const float aa1 = A * A - 1.0f;
    const float tmp = clamp_max(rdiv(1.0f, aa1 == 0.0f ? PYF(1e-10) : aa1), PYF(1e10));
    const float B = tan_t;
    const float D = safe_sqrt(B * B * tmp * tmp - (A * A - B * B) * tmp);
    const float sx1 = B * tmp - D;
    const float sx2 = B * tmp + D;
    const float sx_g =
        (A < 0.0f || sx2 > rdiv(1.0f, tan_t == 0.0f ? PYF(1e-12) : tan_t)) ? sx1 : sx2;
    const float S = uy > PYF(0.5) ? 1.0f : -1.0f;
    const float u2b = uy > PYF(0.5) ? 2.0f * (uy - PYF(0.5)) : 2.0f * (PYF(0.5) - uy);
    const float z = (u2b * (u2b * (u2b * PYF(0.27385) - PYF(0.73369)) + PYF(0.46341))) /
                    (u2b * (u2b * (u2b * PYF(0.093073) + PYF(0.309420)) - 1.0f) + PYF(0.597999));
    const float sy_g = S * z * sqrtf(1.0f + sx_g * sx_g);

    const bool near = cti > PYF(0.9999);
    float slope_x = near ? sx_n : sx_g;
    float slope_y = near ? sy_n : sy_g;
    const float cp = cos_phi(wi_str), sp = sin_phi(wi_str);
    const float rx = cp * slope_x - sp * slope_y;
    const float ry = sp * slope_x + cp * slope_y;
    slope_x = rx * ax;
    slope_y = ry * ay;
    V wh = normalize(V{-slope_x, -slope_y, 1.0f});
    wh = flip ? -wh : wh;
    const float g1o = rdiv(1.0f, 1.0f + tr_lambda(wo, ax, ay));
    pdf = tr_d(wh, ax, ay, pi) * g1o * fabsf(dot(wo, wh)) / clamp_min(fabsf(wo.z), PYF(1e-12));
    return wh;
}

// --- the lobes (ops/bsdf.lobe_f, lobe_sample), in the shading frame

struct LobeVals {
    V albedo;
    float ax, ay, eta_a, eta_b;
};

__device__ __forceinline__ LobeVals lobe_vals(const LobeArgs& l, int i) {
    LobeVals v;
    v.albedo = load3(l.albedo, i);
    if (l.kind == GGX_R) {
        v.ax = load1(l.alpha_x, i);
        v.ay = load1(l.alpha_y, i);
        v.eta_a = load1(l.eta_a, i);
        v.eta_b = load1(l.eta_b, i);
    }
    return v;
}

// lobe_f → f, and whether it is present.
__device__ V lobe_f(const LobeArgs& l, const LobeVals& v, V wo, V wi, const Consts& k,
                    bool& present) {
    if (l.kind == LAMBERT_R) {
        present = true;
        return v.albedo * k.inv_pi;
    }
    // ggx_r
    const float co = fabsf(wo.z);
    const float ci = fabsf(wi.z);
    const V win = normalize(wi);
    const V won = normalize(wo);
    V wh = win + won;
    const bool degenerate =
        (fabsf(wh.x) + fabsf(wh.y) + fabsf(wh.z) == 0.0f) || co == 0.0f || ci == 0.0f;
    const V wo_up = {wo.x, wo.y, wo.z + 1.0f};
    wh = normalize(degenerate ? wo_up : wh);
    const float fr_cos = dot(win, wh.z < 0.0f ? -wh : wh);
    const float fr = l.fresnel_noop ? 1.0f : fresnel_dielectric(fr_cos, v.eta_a, v.eta_b);
    const float g = rdiv(1.0f, 1.0f + tr_lambda(won, v.ax, v.ay) + tr_lambda(win, v.ax, v.ay));
    const float s = tr_d(wh, v.ax, v.ay, k.pi) * g * fr / clamp_min(4.0f * co * ci, PYF(1e-12));
    present = !degenerate;
    return degenerate ? V{0.0f, 0.0f, 0.0f} : v.albedo * s;
}

// ops/math.concentric_sample_disk
__device__ __forceinline__ void concentric_disk(float u0, float u1, float pi, float& dx, float& dy) {
    const float ux = 2.0f * u0 - 1.0f;
    const float uy = 2.0f * u1 - 1.0f;
    const bool zero = ux == 0.0f || uy == 0.0f;
    const bool use_x = fabsf(ux) > fabsf(uy);
    const float safe_ux = ux == 0.0f ? 1.0f : ux;
    const float safe_uy = uy == 0.0f ? 1.0f : uy;
    const float r = use_x ? ux : uy;
    const float theta =
        use_x ? (uy / safe_ux) * (pi * 0.25f) : pi * 0.5f - (ux / safe_uy) * (pi * 0.25f);
    dx = zero ? 0.0f : r * cosf(theta);
    dy = zero ? 0.0f : r * sinf(theta);
}

// lobe_sample → wi, f, pdf, present.
__device__ V lobe_sample(const LobeArgs& l, const LobeVals& v, V wo, float u0, float u1,
                         const Consts& k, V& f, float& pdf, bool& present) {
    if (l.kind == LAMBERT_R) {
        float dx, dy;
        concentric_disk(u0, u1, k.pi, dx, dy);
        const float z = safe_sqrt(1.0f - (dx * dx + dy * dy));
        pdf = z * k.inv_pi;
        const V wi = {dx, dy, wo.z < 0.0f ? -z : z};
        f = lobe_f(l, v, wo, wi, k, present);
        return wi;
    }
    // ggx_r
    float wh_pdf;
    const V wh = tr_sample_wh(wo, u0, u1, v.ax, v.ay, k.pi, wh_pdf);
    const float dot_owh = dot(wo, wh);
    const V wi = -wo + wh * (2.0f * dot_owh);
    const bool ok = wo.z != 0.0f && dot_owh >= 0.0f && wi.z * wo.z > 0.0f;
    bool fp;
    f = lobe_f(l, v, wo, wi, k, fp);
    pdf = ok ? wh_pdf / clamp_min(4.0f * dot_owh, PYF(1e-12)) : 0.0f;
    present = ok && fp;
    return wi;
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

    // the shading frame (ops/math.coordinate_system), local +z = n
    const bool use_x = fabsf(n.x) > fabsf(n.y);
    const float den = use_x ? n.x * n.x + n.z * n.z : n.y * n.y + n.z * n.z;
    const float inv_a = rsqrtf(den == 0.0f ? 1.0f : den);
    const V fx = use_x ? V{-n.z * inv_a, 0.0f * inv_a, n.x * inv_a}
                       : V{0.0f * inv_a, n.z * inv_a, -n.y * inv_a};
    const V fy = cross(n, fx);
    const V wi_l = {dot(wi, fx), dot(wi, fy), dot(wi, n)};
    const V wo_l = {dot(wo, fx), dot(wo, fy), dot(wo, n)};

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
    const V wi2 = fx * wi2_l.x + fy * wi2_l.y + n * wi2_l.z;
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

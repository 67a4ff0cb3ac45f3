// The path continuation for Hopper (sm_90a): the tail of one bounce of
// models/integrators.path_trace (continue_path_plain), one lane a thread.
//
//   continue_kernel  the shading frame, the lane's own family's BSDF sample
//                    (bsdf_sample: the bucket choice, one non-delta lobe
//                    chosen uniformly or the delta lobes' luminance-weighted
//                    choice), to_world, the throughput, the spawned ray's
//                    offset origin, the path state's update and, past
//                    bounce 3, Russian roulette; writes the new o, d, beta,
//                    specular and active.
//
// Replaces no TPU kernel: the JAX package's continuation
// (curry_pbrt_tpu/models/integrators.py path_trace) is jnp, which XLA fuses.
// In the port it was some hundreds of full-width PyTorch ops a bounce: every
// family's whole bsdf_sample run for every lane and selected by material,
// every (N, 3) temporary written to device memory and read back, and dead
// lanes computed like live ones.
//
// What bounds it on an H100: bytes. A live lane reads its hit (p, n,
// p_error: 36 B), d and beta (24 B), its material id and two flags (6 B),
// two or three sampler values (8–12 B) and the lobe constants of the lobes
// it samples (0–40 B; a broadcast constant is read once per warp), and
// writes o, d, beta and two flags (38 B): ~115–160 B a lane, ~0.2 ms for a
// 4,194,304-lane bounce at 3.35 TB/s. The design answers that with one
// thread a lane and no temporaries in device memory, each lane sampling only
// its own family's lobes (a table from material id to the slot of its
// family among all the plan's families; each slot's lobe tensors passed by
// pointer and strides, so an expanded constant is read with stride 0, never
// copied). A lane that is not active, or whose material has no family,
// samples nothing: it copies its o, d, beta and specular and stays dead.
// Russian roulette's reweight divides every lane's beta, dead or alive, as
// the plain path does.
//
// Numerics: shading.cuh's note. Lobe kinds: lambert_r and ggx_r (shared
// with nee.cu), spec_r (dielectric Fresnel, or none for the mirror) and
// spec_t; integrators.continue_path sends any other plan to the plain path.

#include "shading.cuh"

namespace curry {
namespace {

constexpr int THREADS = 256;

// A family's lobes: its non-delta lobes lobe[0, n_nd) in the plain path's
// order, then its delta lobes lobe[n_nd, n_nd + n_d) in theirs.
struct ShadeFam {
    int n_nd, n_d;
    float p_nb, p_d;  // bsdf_sample's bucket probabilities, rounded in float32
    LobeArgs lobe[MAX_LOBES];
};

struct ContinueArgs {
    int n, n_fams, roulette, pad;  // roulette: the bounce is past 3
    Consts k;
    const unsigned char* active;    // (n,) bool: the path is alive at this hit
    const unsigned char* specular;  // (n,) bool
    const int* mat_ids;             // (n,) int32, -1 on a miss
    const int* fam_slot;            // (n_mats + 1,) int32 by mat id + 1: family slot, -1 none
    Rows3 p, nrm, perr, o, d, beta;
    Rows1 u_bucket, u_extra, u_rr;  // u_rr read only when roulette
    float* o_out;                   // (n, 3) each
    float* d_out;
    float* beta_out;
    unsigned char* active_out;  // (n,) bool
    unsigned char* specular_out;
    ShadeFam fam[MAX_FAMS];
};

// ops/bsdf.luminance
__device__ __forceinline__ float luminance(V c) {
    return PYF(0.212671) * c.x + PYF(0.715160) * c.y + PYF(0.072169) * c.z;
}

// ops/bsdf.delta_lobe_sample → wi, f, present (spec_r or spec_t).
__device__ V delta_sample(const LobeArgs& l, int i, V wo, V& f, bool& present) {
    const V albedo = load3(l.albedo, i);
    if (l.kind == SPEC_R) {
        const V wi = {-wo.x, -wo.y, wo.z};
        const float ci = wi.z;
        const float fr =
            l.fresnel_noop ? 1.0f : fresnel_dielectric(ci, load1(l.eta_a, i), load1(l.eta_b, i));
        f = albedo * (fr / clamp_min(fabsf(ci), PYF(1e-12)));
        present = fr != 0.0f;
        return wi;
    }
    // spec_t: refraction about (0, 0, sign(wo.z)) (ops/math.refract)
    const float ea = load1(l.eta_a, i), eb = load1(l.eta_b, i);
    const float eta = wo.z > 0.0f ? ea / eb : eb / ea;
    const float sgn = (float)((0.0f < wo.z) - (wo.z < 0.0f));  // torch.sign
    const float cos_o = wo.x * 0.0f + wo.y * 0.0f + wo.z * sgn;
    const float sin2_o = 1.0f - cos_o * cos_o;
    const float sin2_i = sin2_o * eta * eta;
    const bool ok = sin2_i <= 1.0f;
    const float cos_i = safe_sqrt(1.0f - sin2_i);
    const float t = eta * cos_o - cos_i;
    const V wi = {eta * -wo.x + t * 0.0f, eta * -wo.y + t * 0.0f, eta * -wo.z + t * sgn};
    const float ft = 1.0f - fresnel_dielectric(wi.z, ea, eb);
    f = albedo * (ft / clamp_min(fabsf(wi.z), PYF(1e-12)));
    present = ok && ft != 0.0f;
    return wi;
}

// ops/bsdf.bsdf_sample_nondelta: one non-delta lobe, chosen uniformly.
__device__ V sample_nondelta(const ShadeFam& fam, int i, V wo, float u_pick, float u2,
                             const Consts& k, V& f, float& pdf, bool& present) {
    const float fu = u_pick * (float)fam.n_nd;
    const int j = min((int)fu, fam.n_nd - 1);
    const LobeArgs& l = fam.lobe[j];
    const V wi = lobe_sample(l, lobe_vals(l, i), wo, fu - floorf(fu), u2, k, f, pdf, present);
    pdf = pdf * (1.0f / (float)fam.n_nd);
    return wi;
}

// ops/bsdf.bsdf_sample_delta: the luminance-weighted CDF walk over the
// delta lobes that give a sample; the chosen lobe's sample is taken again
// (the same ops on the same values: the same bits) rather than kept.
__device__ V sample_delta(const ShadeFam& fam, int i, V wo, float u, V& f, float& pdf,
                          bool& present) {
    float w[MAX_LOBES] = {};
    float total = 0.0f;
#pragma unroll
    for (int j = 0; j < MAX_LOBES; ++j) {
        if (j < fam.n_d) {
            V fj;
            bool ok;
            delta_sample(fam.lobe[fam.n_nd + j], i, wo, fj, ok);
            w[j] = ok ? clamp_min(luminance(fj), 0.0f) : 0.0f;
            total = j == 0 ? w[j] : total + w[j];
        }
    }
    const bool any_ok = total > 0.0f;
    const float safe_total = any_ok ? total : 1.0f;
    const float target = u * safe_total;
    float cum = 0.0f;
    int chosen = fam.n_d - 1;
    bool done = false;
#pragma unroll
    for (int j = 0; j < MAX_LOBES; ++j) {
        if (j < fam.n_d) {
            cum = cum + w[j];
            const bool take = !done && target <= cum && w[j] > 0.0f;
            chosen = take ? j : chosen;
            done = done || take;
        }
    }
    float wc = 0.0f;
#pragma unroll
    for (int j = 0; j < MAX_LOBES; ++j) wc = j == chosen ? w[j] : wc;
    bool ok;
    const V wi = delta_sample(fam.lobe[fam.n_nd + chosen], i, wo, f, ok);
    pdf = ok ? wc / safe_total : 0.0f;
    present = ok && any_ok;
    if (!ok) f = V{0.0f, 0.0f, 0.0f};
    return ok ? wi : V{0.0f, 0.0f, 0.0f};
}

// ops/bsdf.bsdf_sample: the delta or non-delta bucket with probability
// proportional to the lobe counts, then a sample within it.
__device__ V bsdf_sample(const ShadeFam& fam, int i, V wo, float u_bucket, float u_extra,
                         const Consts& k, V& f, float& pdf, bool& present, bool& is_delta) {
    f = V{0.0f, 0.0f, 0.0f};
    pdf = 0.0f;
    present = false;
    is_delta = false;
    if (fam.n_nd == 0 && fam.n_d == 0) return V{0.0f, 0.0f, 0.0f};
    if (fam.n_d == 0) return sample_nondelta(fam, i, wo, 1.0f - u_bucket, u_extra, k, f, pdf, present);
    if (fam.n_nd == 0) {
        is_delta = true;
        return sample_delta(fam, i, wo, 1.0f - u_bucket, f, pdf, present);
    }
    V wi;
    if (u_bucket <= fam.p_nb) {
        wi = sample_nondelta(fam, i, wo, (fam.p_nb - u_bucket) * (1.0f / fam.p_nb), u_extra, k, f,
                             pdf, present);
        pdf = pdf * fam.p_nb;
    } else {
        wi = sample_delta(fam, i, wo, (1.0f - u_bucket) * (1.0f / fam.p_d), f, pdf, present);
        pdf = pdf * fam.p_d;
        is_delta = true;
    }
    return wi;
}

__device__ void continue_lane(const ContinueArgs& a, int i) {
    V beta = load3(a.beta, i);
    const bool active = a.active[i];
    const int slot = active ? __ldg(a.fam_slot + __ldg(a.mat_ids + i) + 1) : -1;
    bool cont = false, specular = false;
    V o, d;
    if (slot >= 0) {
        const V p = load3(a.p, i), n = load3(a.nrm, i), perr = load3(a.perr, i);
        const V wo = -load3(a.d, i);
        V fx, fy;
        shading_frame(n, fx, fy);
        V f;
        float pdf;
        bool present, is_delta;
        const V wi_l = bsdf_sample(a.fam[slot], i, to_local(wo, fx, fy, n), load1(a.u_bucket, i),
                                   load1(a.u_extra, i), a.k, f, pdf, present, is_delta);
        cont = present && pdf != 0.0f;
        if (cont) {
            const V wi = to_world(wi_l, fx, fy, n);
            beta = beta * (f * (fabsf(dot(wi, n)) / pdf));
            o = offset_point(p, n, perr, wi);
            d = wi;
            specular = is_delta;
        }
    }
    if (!cont) {  // the path keeps its ray and state
        o = load3(a.o, i);
        d = load3(a.d, i);
        specular = a.specular[i];
    }
    bool alive = cont;
    if (a.roulette) {  // Russian roulette (path.rs:47-56)
        const float q = clamp_min(1.0f - luminance(beta), PYF(0.05));
        if (alive) alive = !(load1(a.u_rr, i) < q);
        const float keep = clamp_min(1.0f - q, PYF(1e-6));
        beta = V{beta.x / keep, beta.y / keep, beta.z / keep};
    }
    store3(a.o_out, i, o);
    store3(a.d_out, i, d);
    store3(a.beta_out, i, beta);
    a.active_out[i] = alive;
    a.specular_out[i] = specular;
}

__global__ void __launch_bounds__(THREADS) continue_kernel(const ContinueArgs a) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < a.n) continue_lane(a, i);
}

}  // namespace
}  // namespace curry

// Plain C interface for ctypes: the argument struct is host memory laid out
// as above (ops/kernels/shade.py mirrors it; the size function lets it
// check); its pointers are device pointers. The launch goes on `stream` and
// does not synchronise. Returns cudaGetLastError().
extern "C" int curry_shade_continue_args_size() { return (int)sizeof(curry::ContinueArgs); }

extern "C" int curry_shade_continue(const void* args, void* stream) {
    const curry::ContinueArgs& a = *static_cast<const curry::ContinueArgs*>(args);
    if (a.n < 0 || a.n_fams < 0 || a.n_fams > curry::MAX_FAMS)
        return static_cast<int>(cudaErrorInvalidValue);
    for (int s = 0; s < a.n_fams; ++s) {
        const curry::ShadeFam& fam = a.fam[s];
        if (fam.n_nd < 0 || fam.n_d < 0 || fam.n_nd + fam.n_d > curry::MAX_LOBES)
            return static_cast<int>(cudaErrorInvalidValue);
    }
    if (a.n == 0) return static_cast<int>(cudaSuccess);
    const int blocks = (a.n + curry::THREADS - 1) / curry::THREADS;
    curry::continue_kernel<<<blocks, curry::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return static_cast<int>(cudaGetLastError());
}

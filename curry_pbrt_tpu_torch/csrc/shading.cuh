// Per-lane shading code shared by next-event estimation (nee.cu) and the
// path continuation (shade.cu): vectors and loads, the shading frame, the
// spawn offset, Fresnel, Trowbridge-Reitz and the lobes of ops/bsdf.py.
//
// Numerics: built like every csrc kernel (-fmad=false, IEEE division and
// square root), and written op for op in the plain path's order: each
// three-term dot product as its products summed left to right, `c / x`
// as PyTorch computes it (reciprocal(x) · c), `x / c` for a host scalar as
// x · (1/c) in float32 (PyTorch's division by a CPU scalar), `x / y` for
// two tensors a true division, clamps that pass NaN through, the same
// where-guards and the same NaN / inf scrubs. Python float constants enter
// as float(double), as PyTorch rounds them; numpy float32 constants come
// from the wrappers.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace curry {
namespace {

// lobe kinds and the limits on a plan's family slots (ops/kernels/shading.py)
constexpr int LAMBERT_R = 0, GGX_R = 1, SPEC_R = 2, SPEC_T = 3;
constexpr int MAX_FAMS = 8;   // family slots of a plan
constexpr int MAX_LOBES = 4;  // lobes of a family
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
    Rows1 alpha_x, alpha_y;  // ggx_r
    Rows1 eta_a, eta_b;      // ggx_r, spec_r (unless fresnel_noop), spec_t
};

struct Consts {
    float pi, inv_pi, g6, shadow_t, fmax;
    int n_lights;
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

// The shading frame (ops/math.coordinate_system, integrators._shading_frame):
// local +z = n.
__device__ __forceinline__ void shading_frame(V n, V& fx, V& fy) {
    const bool use_x = fabsf(n.x) > fabsf(n.y);
    const float den = use_x ? n.x * n.x + n.z * n.z : n.y * n.y + n.z * n.z;
    const float inv_a = rsqrtf(den == 0.0f ? 1.0f : den);
    fx = use_x ? V{-n.z * inv_a, 0.0f * inv_a, n.x * inv_a}
               : V{0.0f * inv_a, n.z * inv_a, -n.y * inv_a};
    fy = cross(n, fx);
}

// ops/math.to_local and to_world
__device__ __forceinline__ V to_local(V w, V fx, V fy, V n) { return {dot(w, fx), dot(w, fy), dot(w, n)}; }
__device__ __forceinline__ V to_world(V w, V fx, V fy, V n) { return fx * w.x + fy * w.y + n * w.z; }

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

}  // namespace
}  // namespace curry

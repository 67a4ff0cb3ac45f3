"""Material compilation: pbrt material directives → static lobe constructors.

The reference's materials are trait objects that build a BSDF per
intersection (reference src/material/). Here each `Material` directive
compiles to a `CompiledMaterial` whose lobe STRUCTURE is static (decided from
compile-time-constant parameters) and whose VALUES live in the differentiable
params pytree. At shading time the integrator loops over the (small, deduped)
list of material instances, builds each instance's lobes for the full ray
batch, and masks lanes by material id in place of per-ray virtual
dispatch; it vectorizes exactly because each instance's lobe list is static.
Counterpart of the JAX package's models/materials.py: the host half is
copied; the lobe evaluation takes torch tensors.

Defaults per material kind follow material/mod.rs:52-154 (matte Kd=0.5
sigma=0; glass Kr=0.5 Kt=1 eta=1.5; mirror Kr=1; plastic Kd=Ks=0.25
rough=0.1; uber incl. opacity; translucent reflect/transmit=0.5; mix by
named materials). Two reference quirks reproduced deliberately:
  * uber reads "uroughness" for BOTH u and v roughness (mod.rs:119-121);
  * Oren-Nayar's A term uses σ (not σ²) in the denominator
    (bxdf/oren_nayar.rs:12).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from curry_pbrt_tpu_torch.ops import bsdf as B
from curry_pbrt_tpu_torch.ops.kernels.texel_grad import TexelGather


@dataclass(frozen=True)
class TexRef:
    """A spectrum/float parameter source: compile-time constant (promoted to
    a differentiable param) or a named image texture."""

    kind: str  # 'const' | 'texture'
    const: Optional[Tuple[float, ...]] = None  # rgb triple or (float,)
    tex: Optional[str] = None  # texture name in params['textures']

    @staticmethod
    def rgb(v) -> "TexRef":
        a = np.broadcast_to(np.asarray(v, np.float64), (3,))
        return TexRef("const", tuple(float(x) for x in a))

    @staticmethod
    def f(v: float) -> "TexRef":
        return TexRef("const", (float(v),))

    @staticmethod
    def texture(name: str) -> "TexRef":
        return TexRef("texture", None, name)

    @property
    def is_black(self) -> bool:
        return self.kind == "const" and all(x == 0.0 for x in self.const)

    @property
    def is_const(self) -> bool:
        return self.kind == "const"


def eval_texref(ref: TexRef, uv, params, mat_id: int, slot: str, want_rgb: bool):
    """Evaluate a parameter for a ray batch. uv: (N,2).

    Constants read from params['materials'][mat_id][slot]; textures do a
    nearest-neighbor gather with the reference's v-flip
    (texture/image.rs:92-105). Float params from rgb textures use luminance
    (image.rs ImageTextureContent for Float)."""
    if ref.kind == "const":
        v = params["materials"][str(mat_id)][slot]
        if want_rgb:
            return torch.broadcast_to(v, uv.shape[:-1] + (3,))
        return torch.broadcast_to(v[..., 0] if v.ndim else v, uv.shape[:-1])
    img = params["textures"][ref.tex]  # (H, W, 3)
    h, w = img.shape[0], img.shape[1]
    x = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1).long()
    y = torch.clamp(((1.0 - uv[..., 1]) * h).to(torch.int32), 0, h - 1).long()
    # one row gather from the flattened (H·W, 3) table; under autograd its
    # backward is the deterministic segment sum of ops/kernels/texel_grad.py
    if torch.is_grad_enabled() and img.requires_grad:
        texel = TexelGather.apply(img, y * w + x)
    else:
        texel = img.reshape(-1, 3)[y * w + x]
    if want_rgb:
        return texel
    return B.luminance(texel)


@dataclass
class CompiledMaterial:
    kind: str
    mat_id: int
    refs: Dict[str, TexRef]
    # static lobe-structure decisions (from compile-time constants):
    lobe_plan: Tuple[str, ...] = ()

    def param_values(self) -> Dict[str, torch.Tensor]:
        """Initial differentiable values for params['materials'][id]
        (float32 CPU tensors; the renderer moves params to its device)."""
        out = {}
        for slot, ref in self.refs.items():
            if ref.kind == "const":
                out[slot] = torch.tensor(
                    ref.const if len(ref.const) > 1 else ref.const[0], dtype=torch.float32
                )
        return out

    # -- lobe construction ------------------------------------------------

    def make_lobes(self, uv, params, material_registry=None, ev=None) -> List[B.Lobe]:
        """Build this material's lobes for a ray batch. `ev`, when given, is
        an (ev_rgb, ev_f) pair of slot evaluators — used by MaterialFamily to
        substitute per-lane gathered parameters for the per-instance ones."""
        if ev is not None:
            ev_rgb, ev_f = ev
        else:
            ev_rgb = lambda slot: eval_texref(self.refs[slot], uv, params, self.mat_id, slot, True)
            ev_f = lambda slot: eval_texref(self.refs[slot], uv, params, self.mat_id, slot, False)
        k = self.kind
        ones = torch.ones(uv.shape[:-1], dtype=torch.float32, device=uv.device)

        if k == "matte":
            kd = ev_rgb("Kd")
            if "use_oren_nayar" in self.lobe_plan:
                sigma = torch.deg2rad(torch.clamp(ev_f("sigma"), 0.0, 90.0))
                s2 = sigma * sigma
                a = 1.0 - s2 / (2.0 * (sigma + 0.33))  # reference quirk: σ not σ²
                b = 0.45 * s2 / (s2 + 0.09)
                return [B.Lobe("oren_nayar", kd, on_a=a, on_b=b)]
            return [B.Lobe("lambert_r", kd)]

        if k == "glass":
            r, t = ev_rgb("Kr"), ev_rgb("Kt")
            eta = ev_f("index")
            return [
                B.Lobe("spec_r", r, eta_a=ones, eta_b=eta),
                B.Lobe("spec_t", t, eta_a=ones, eta_b=eta),
            ]

        if k == "mirror":
            return [B.Lobe("spec_r", ev_rgb("Kr"), fresnel_noop=True)]

        if k == "plastic":
            lobes = []
            if "kd" in self.lobe_plan:
                lobes.append(B.Lobe("lambert_r", ev_rgb("Kd")))
            if "ks" in self.lobe_plan:
                alpha = B.roughness_to_alpha(ev_f("roughness"))
                lobes.append(
                    B.Lobe(
                        "ggx_r", ev_rgb("Ks"), alpha_x=alpha, alpha_y=alpha,
                        eta_a=ones, eta_b=1.5 * ones,
                    )
                )
            return lobes

        if k == "uber":
            lobes = []
            eta = ev_f("eta")
            opacity = ev_rgb("opacity")
            if "passthrough" in self.lobe_plan:
                lobes.append(
                    B.Lobe("spec_t", 1.0 - opacity, eta_a=ones, eta_b=ones)
                )
            if "kd" in self.lobe_plan:
                lobes.append(B.Lobe("lambert_r", opacity * ev_rgb("Kd")))
            if "ks" in self.lobe_plan:
                ru = ev_f("uroughness") if "uroughness" in self.refs else ev_f("roughness")
                # reference quirk: vroughness also reads "uroughness"
                rv = ru
                lobes.append(
                    B.Lobe(
                        "ggx_r", opacity * ev_rgb("Ks"),
                        alpha_x=B.roughness_to_alpha(ru), alpha_y=B.roughness_to_alpha(rv),
                        eta_a=ones, eta_b=eta,
                    )
                )
            if "kr" in self.lobe_plan:
                lobes.append(
                    B.Lobe("spec_r", opacity * ev_rgb("Kr"), eta_a=ones, eta_b=eta)
                )
            if "kt" in self.lobe_plan:
                lobes.append(
                    B.Lobe("spec_t", opacity * ev_rgb("Kt"), eta_a=ones, eta_b=eta)
                )
            return lobes

        if k == "translucent":
            lobes = []
            r, t = ev_rgb("reflect"), ev_rgb("transmit")
            if "kd_r" in self.lobe_plan or "kd_t" in self.lobe_plan:
                kd = ev_rgb("Kd")
                if "kd_r" in self.lobe_plan:
                    lobes.append(B.Lobe("lambert_r", r * kd))
                if "kd_t" in self.lobe_plan:
                    lobes.append(B.Lobe("lambert_t", t * kd))
            if "ks_r" in self.lobe_plan or "ks_t" in self.lobe_plan:
                ks = ev_rgb("Ks")
                alpha = B.roughness_to_alpha(ev_f("roughness"))
                if "ks_r" in self.lobe_plan:
                    lobes.append(
                        B.Lobe("ggx_r", r * ks, alpha_x=alpha, alpha_y=alpha,
                               eta_a=ones, eta_b=1.5 * ones)
                    )
                if "ks_t" in self.lobe_plan:
                    lobes.append(
                        B.Lobe("ggx_t", t * ks, alpha_x=alpha, alpha_y=alpha,
                               eta_a=ones, eta_b=1.5 * ones)
                    )
            return lobes

        if k == "mix":
            # BSDF-level blend: m1 lobes scaled by s, m2 by 1-s
            # (material/mix.rs:11-16 + bxdf/mod.rs:218-269)
            m1: CompiledMaterial = material_registry[self.refs["namedmaterial1"].tex]
            m2: CompiledMaterial = material_registry[self.refs["namedmaterial2"].tex]
            s = eval_texref(self.refs["amount"], uv, params, self.mat_id, "amount", True)
            if self.refs["amount"].is_black:
                return m2.make_lobes(uv, params, material_registry)
            if self.refs["amount"].is_const and all(x == 1.0 for x in self.refs["amount"].const):
                return m1.make_lobes(uv, params, material_registry)
            lobes = []
            for l in m1.make_lobes(uv, params, material_registry):
                lobes.append(_scale_lobe(l, s))
            for l in m2.make_lobes(uv, params, material_registry):
                lobes.append(_scale_lobe(l, 1.0 - s))
            return lobes

        raise ValueError(f"unknown material kind {k!r}")

    def counts(self, registry) -> Tuple[int, int]:
        """(n_nondelta, n_delta) — static per instance."""
        kinds = lobe_kinds(self, registry)
        nd = sum(1 for x in kinds if x in B.DELTA_KINDS)
        return len(kinds) - nd, nd

    def is_all_delta(self, registry) -> bool:
        return self.counts(registry)[0] == 0


@dataclass
class MaterialFamily:
    """Shading-dispatch group: material INSTANCES sharing (kind, lobe_plan,
    texture bindings, ref slots) evaluate as ONE vectorized lobe stack, with
    per-lane constants gathered from a stacked member-parameter table by each
    lane's material id. This is the vectorized answer to 'shading scales linearly in
    distinct material instances' (the reference dispatches per-ray through
    trait objects — material/mod.rs:23-26 — so it never pays this): a scene
    with 10,000 matte instances shades in one pass, not 10,000.

    Membership and member position are gathers from (n_mats + 1,) tables
    indexed by mat_id + 1 (slot 0 is the miss id -1), built once on the
    render device (build_tables); each constant slot's member values are
    stacked from the params tree once per chunk (stack_params, called by
    render._chunk_sample_radiance, so that a chunk's autograd graph holds
    its own stacking). Shading time has no loop over members."""

    members: List[CompiledMaterial]
    is_member: Optional[torch.Tensor] = None  # (n_mats + 1,) bool
    local_of: Optional[torch.Tensor] = None  # (n_mats + 1,) int64 member position
    stacked: Optional[Dict[str, torch.Tensor]] = None  # slot → (k, 3) or (k,)

    @property
    def rep(self) -> CompiledMaterial:
        return self.members[0]

    @property
    def member_ids(self) -> List[int]:
        return [mat.mat_id for mat in self.members]

    def build_tables(self, n_mats: int, device) -> None:
        """Member flag and local index by material id, on `device`."""
        flag = np.zeros((n_mats + 1,), bool)
        local = np.zeros((n_mats + 1,), np.int64)
        ids = np.asarray(self.member_ids, np.int64) + 1
        flag[ids] = True
        local[ids] = np.arange(len(self.members))
        self.is_member = torch.as_tensor(flag, device=device)
        self.local_of = torch.as_tensor(local, device=device)

    def stack_params(self, params) -> None:
        """Stack each constant slot's member values from the params tree:
        (k, 3) for spectra, (k,) for floats (the first component)."""
        self.stacked = {}
        for slot, ref in self.rep.refs.items():
            if ref.kind != "const":
                continue
            vals = [params["materials"][str(mat.mat_id)][slot] for mat in self.members]
            if len(ref.const) > 1:
                self.stacked[slot] = torch.stack([torch.broadcast_to(v, (3,)) for v in vals])
            else:
                self.stacked[slot] = torch.stack([torch.reshape(v, (-1,))[0] for v in vals])

    def mask(self, mat_ids):
        """(N,) bool — lanes shaded by any member (mat_ids: -1 on a miss)."""
        return self.is_member[mat_ids.long() + 1]

    def _local_idx(self, mat_ids):
        """(N,) int64 — each lane's member position (0 where not a member)."""
        return self.local_of[mat_ids.long() + 1]

    def make_lobes(self, uv, params, registry, mat_ids) -> List[B.Lobe]:
        rep = self.rep
        if len(self.members) == 1:
            return rep.make_lobes(uv, params, registry)
        local = self._local_idx(mat_ids)

        def ev(slot: str, want_rgb: bool):
            ref = rep.refs[slot]
            if ref.kind == "texture":
                return eval_texref(ref, uv, params, rep.mat_id, slot, want_rgb)
            stacked = self.stacked[slot]
            if want_rgb:  # a float slot read as rgb repeats its value
                return (stacked if stacked.ndim == 2 else stacked[:, None].expand(-1, 3))[local]
            return (stacked[:, 0] if stacked.ndim == 2 else stacked)[local]

        return rep.make_lobes(
            uv, params, registry,
            ev=(lambda s: ev(s, True), lambda s: ev(s, False)),
        )


def family_key(mat: CompiledMaterial) -> tuple:
    """Materials group into a family iff this key matches. mix is excluded
    (its lobes come from registry member materials — one family each)."""
    if mat.kind == "mix":
        return ("mix", mat.mat_id)
    ref_sig = tuple(
        (slot, ref.kind, ref.tex, len(ref.const or ()))
        for slot, ref in sorted(mat.refs.items())
    )
    return (mat.kind, mat.lobe_plan, ref_sig)


def build_families(materials: List[CompiledMaterial], n_mats: int, device) -> List[MaterialFamily]:
    """Group materials into families; n_mats bounds every mat_id. Each
    family's lookup tables are built on `device`."""
    groups: Dict[tuple, List[CompiledMaterial]] = {}
    for mat in materials:
        groups.setdefault(family_key(mat), []).append(mat)
    families = [MaterialFamily(m) for m in groups.values()]
    for fam in families:
        fam.build_tables(n_mats, device)
    return families


def _scale_lobe(l: B.Lobe, s) -> B.Lobe:
    return B.Lobe(
        l.kind, l.albedo * s, on_a=l.on_a, on_b=l.on_b, alpha_x=l.alpha_x,
        alpha_y=l.alpha_y, eta_a=l.eta_a, eta_b=l.eta_b, fresnel_noop=l.fresnel_noop,
    )


def lobe_kinds(mat: CompiledMaterial, registry) -> List[str]:
    """Static lobe kind list (for bucket counts / is_all_delta)."""
    k = mat.kind
    if k == "matte":
        return ["oren_nayar" if "use_oren_nayar" in mat.lobe_plan else "lambert_r"]
    if k == "glass":
        return ["spec_r", "spec_t"]
    if k == "mirror":
        return ["spec_r"]
    if k == "plastic":
        out = []
        if "kd" in mat.lobe_plan:
            out.append("lambert_r")
        if "ks" in mat.lobe_plan:
            out.append("ggx_r")
        return out
    if k == "uber":
        out = []
        if "passthrough" in mat.lobe_plan:
            out.append("spec_t")
        if "kd" in mat.lobe_plan:
            out.append("lambert_r")
        if "ks" in mat.lobe_plan:
            out.append("ggx_r")
        if "kr" in mat.lobe_plan:
            out.append("spec_r")
        if "kt" in mat.lobe_plan:
            out.append("spec_t")
        return out
    if k == "translucent":
        order = [("kd_r", "lambert_r"), ("kd_t", "lambert_t"), ("ks_r", "ggx_r"), ("ks_t", "ggx_t")]
        return [kind for plan, kind in order if plan in mat.lobe_plan]
    if k == "mix":
        amount = mat.refs["amount"]
        m1 = registry[mat.refs["namedmaterial1"].tex]
        m2 = registry[mat.refs["namedmaterial2"].tex]
        if amount.is_black:
            return lobe_kinds(m2, registry)
        if amount.is_const and all(x == 1.0 for x in amount.const):
            return lobe_kinds(m1, registry)
        return lobe_kinds(m1, registry) + lobe_kinds(m2, registry)
    raise ValueError(k)


# ---------------------------------------------------------------------------
# directive parsing


def _get_spectrum_ref(ps, name: str, default: Optional[TexRef]) -> Optional[TexRef]:
    from curry_pbrt_tpu_torch.sceneio.spd import spd_to_rgb

    p = ps.find(name)
    if p is None:
        return default
    if p.type_name == "texture":
        return TexRef.texture(p.values[0].value)
    if p.type_name == "rgb" or p.type_name == "color":
        v = [float(t.value) for t in p.values]
        return TexRef.rgb(v[:3])
    if p.type_name == "spectrum":
        return TexRef.rgb(spd_to_rgb([float(t.value) for t in p.values]))
    if p.type_name == "float":
        return TexRef.rgb([float(p.values[0].value)] * 3)
    raise ValueError(f"bad spectrum property {name}: {p.type_name}")


def _get_float_ref(ps, name: str, default: Optional[TexRef]) -> Optional[TexRef]:
    p = ps.find(name)
    if p is None:
        return default
    if p.type_name == "texture":
        return TexRef.texture(p.values[0].value)
    return TexRef.f(float(p.values[0].value))


def compile_material(kind: str, ps, mat_id: int) -> CompiledMaterial:
    """Parse one Material/MakeNamedMaterial directive (defaults per
    material/mod.rs:52-154)."""
    refs: Dict[str, TexRef] = {}
    plan: List[str] = []

    def black_aware(slot: str, ref: TexRef, plan_key: str):
        refs[slot] = ref
        if not ref.is_black:
            plan.append(plan_key)

    if kind == "matte":
        refs["Kd"] = _get_spectrum_ref(ps, "Kd", TexRef.rgb([0.5] * 3))
        refs["sigma"] = _get_float_ref(ps, "sigma", TexRef.f(0.0))
        sig = refs["sigma"]
        if not (sig.is_const and sig.const[0] == 0.0):
            plan.append("use_oren_nayar")
    elif kind == "glass":
        refs["Kr"] = _get_spectrum_ref(ps, "Kr", TexRef.rgb([0.5] * 3))
        refs["Kt"] = _get_spectrum_ref(ps, "Kt", TexRef.rgb([1.0] * 3))
        refs["index"] = _get_float_ref(ps, "index", TexRef.f(1.5))
    elif kind == "mirror":
        refs["Kr"] = _get_spectrum_ref(ps, "Kr", TexRef.rgb([1.0] * 3))
    elif kind == "plastic":
        black_aware("Kd", _get_spectrum_ref(ps, "Kd", TexRef.rgb([0.25] * 3)), "kd")
        black_aware("Ks", _get_spectrum_ref(ps, "Ks", TexRef.rgb([0.25] * 3)), "ks")
        refs["roughness"] = _get_float_ref(ps, "roughness", TexRef.f(0.1))
    elif kind == "uber":
        black_aware("Kd", _get_spectrum_ref(ps, "Kd", TexRef.rgb([0.25] * 3)), "kd")
        black_aware("Ks", _get_spectrum_ref(ps, "Ks", TexRef.rgb([0.25] * 3)), "ks")
        black_aware("Kr", _get_spectrum_ref(ps, "Kr", TexRef.rgb([0.0] * 3)), "kr")
        black_aware("Kt", _get_spectrum_ref(ps, "Kt", TexRef.rgb([0.0] * 3)), "kt")
        refs["roughness"] = _get_float_ref(ps, "roughness", TexRef.f(0.1))
        ur = _get_float_ref(ps, "uroughness", None)
        if ur is not None:
            refs["uroughness"] = ur
        eta = _get_float_ref(ps, "eta", None)
        refs["eta"] = eta if eta is not None else _get_float_ref(ps, "index", TexRef.f(1.5))
        op = _get_spectrum_ref(ps, "opacity", TexRef.rgb([1.0] * 3))
        refs["opacity"] = op
        if not (op.is_const and all(x == 1.0 for x in op.const)):
            plan.append("passthrough")
    elif kind == "translucent":
        refs["Kd"] = _get_spectrum_ref(ps, "Kd", TexRef.rgb([0.25] * 3))
        refs["Ks"] = _get_spectrum_ref(ps, "Ks", TexRef.rgb([0.25] * 3))
        refs["reflect"] = _get_spectrum_ref(ps, "reflect", TexRef.rgb([0.5] * 3))
        refs["transmit"] = _get_spectrum_ref(ps, "transmit", TexRef.rgb([0.5] * 3))
        refs["roughness"] = _get_float_ref(ps, "roughness", TexRef.f(0.1))
        r, t, kd, ks = refs["reflect"], refs["transmit"], refs["Kd"], refs["Ks"]
        if not (r.is_black and t.is_black):
            if not kd.is_black:
                if not r.is_black:
                    plan.append("kd_r")
                if not t.is_black:
                    plan.append("kd_t")
            if not ks.is_black:
                if not r.is_black:
                    plan.append("ks_r")
                if not t.is_black:
                    plan.append("ks_t")
    elif kind == "mix":
        refs["amount"] = _get_spectrum_ref(ps, "amount", TexRef.rgb([0.0] * 3))
        refs["namedmaterial1"] = TexRef.texture(ps.get_string("namedmaterial1"))
        refs["namedmaterial2"] = TexRef.texture(ps.get_string("namedmaterial2"))
    else:
        raise ValueError(f"unknown material type {kind!r}")

    return CompiledMaterial(kind, mat_id, refs, tuple(plan))


def dedup_key(mat: CompiledMaterial) -> tuple:
    return (mat.kind, tuple(sorted(mat.refs.items())), mat.lobe_plan)

"""Material families shade through gathers: membership, member position and
per-member constants come from tables indexed by material id, built once
per family and once per render call, with no loop over members at shading
time. The result must be bit-identical to the per-member loops the tables
replaced, which this test keeps as its oracle."""

import numpy as np
import pytest
import torch

from curry_pbrt_tpu_torch.models.materials import (
    CompiledMaterial,
    MaterialFamily,
    TexRef,
    build_families,
)

N_MEMBERS = 300


def _oracle_mask(fam, mat_ids):
    sel = mat_ids == fam.members[0].mat_id
    for mat in fam.members[1:]:
        sel = sel | (mat_ids == mat.mat_id)
    return sel


def _oracle_local(fam, mat_ids):
    idx = torch.zeros(mat_ids.shape, dtype=torch.int64)
    for j, mat in enumerate(fam.members[1:], start=1):
        idx = torch.where(mat_ids == mat.mat_id, j, idx)
    return idx


def _oracle_lobes(fam, uv, params, mat_ids):
    local = _oracle_local(fam, mat_ids)

    def ev(slot, want_rgb):
        vals = [params["materials"][str(mat.mat_id)][slot] for mat in fam.members]
        if want_rgb:
            return torch.stack([torch.broadcast_to(v, (3,)) for v in vals])[local]
        return torch.stack([torch.reshape(v, (-1,))[0] for v in vals])[local]

    return fam.rep.make_lobes(uv, params, {}, ev=(lambda s: ev(s, True), lambda s: ev(s, False)))


@pytest.mark.parametrize("kind", ["plastic", "matte_oren_nayar"])
def test_large_family_gathers_match_the_member_loop(kind):
    rng = np.random.default_rng(5)
    mats = []
    for i in range(2 * N_MEMBERS):
        if i % 2:  # odd ids: a different family (lambert matte)
            refs = {"Kd": TexRef.rgb(rng.uniform(0, 1, 3)), "sigma": TexRef.f(0.0)}
            mats.append(CompiledMaterial("matte", i, refs, ()))
        elif kind == "plastic":
            refs = {"Kd": TexRef.rgb(rng.uniform(0, 1, 3)), "Ks": TexRef.rgb(rng.uniform(0, 1, 3)),
                    "roughness": TexRef.f(rng.uniform(0.01, 0.5))}
            mats.append(CompiledMaterial("plastic", i, refs, ("kd", "ks")))
        else:
            refs = {"Kd": TexRef.rgb(rng.uniform(0, 1, 3)), "sigma": TexRef.f(rng.uniform(5, 40))}
            mats.append(CompiledMaterial("matte", i, refs, ("use_oren_nayar",)))
    params = {"materials": {str(m.mat_id): m.param_values() for m in mats}, "textures": {}}
    families = build_families(mats, n_mats=len(mats), device="cpu")
    fam = next(f for f in families if f.rep.mat_id == 0)
    assert len(fam.members) == N_MEMBERS
    fam.stack_params(params)

    n = 5000
    mat_ids = torch.from_numpy(rng.integers(-1, len(mats), n).astype(np.int32))
    uv = torch.from_numpy(rng.uniform(0, 1, (n, 2)).astype(np.float32))
    assert torch.equal(fam.mask(mat_ids), _oracle_mask(fam, mat_ids))
    assert torch.equal(fam._local_idx(mat_ids), _oracle_local(fam, mat_ids))
    new = fam.make_lobes(uv, params, {}, mat_ids)
    old = _oracle_lobes(fam, uv, params, mat_ids)
    assert [lobe.kind for lobe in new] == [lobe.kind for lobe in old]
    for a, b in zip(new, old):
        for field in ("albedo", "on_a", "on_b", "alpha_x", "alpha_y", "eta_a", "eta_b"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None), field
            if x is not None:
                assert torch.equal(x, y), field


def test_single_member_family_needs_no_tables():
    mat = CompiledMaterial("matte", 0, {"Kd": TexRef.rgb([0.5, 0.2, 0.1]), "sigma": TexRef.f(0.0)}, ())
    (fam,) = build_families([mat], n_mats=1, device="cpu")
    assert isinstance(fam, MaterialFamily)
    mat_ids = torch.tensor([0, -1, 0], dtype=torch.int32)
    assert fam.mask(mat_ids).tolist() == [True, False, True]
    params = {"materials": {"0": mat.param_values()}, "textures": {}}
    fam.stack_params(params)
    (lobe,) = fam.make_lobes(torch.zeros((3, 2)), params, {}, mat_ids)
    assert lobe.kind == "lambert_r" and torch.allclose(lobe.albedo[0], torch.tensor([0.5, 0.2, 0.1]))

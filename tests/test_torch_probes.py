"""The port's traversal-analysis tools (curry_pbrt_tpu_torch/tools/) against
the JAX package's tools on the CPU:

  - the slab-grid probe P's plain version against tools/probe_slab_grid.py's
    `run(interpret=True)` (the Pallas kernel in interpret mode), rtol 1e-5:
    the two sum in other orders;
  - the granularity probe's slab_enter / flops_at against
    tools/probe_granularity.py's on the same numpy inputs: the enter masks
    and the integer (group, cluster) counts are equal, exactly; the chunked
    count equals the whole-mask count;
  - the shared workload's rays, bounce by bounce, against the same
    composition of JAX functions (camera rays, K1 in interpret mode, winner
    attributes, cosine continuation) fed the same numpy jitter and uniforms,
    on cornell_tex at 4,096 rays and depth 3: hit masks and live-lane counts
    equal; t within rtol 1e-6 / atol 1e-4, origins within rtol 1e-5 / atol
    1e-3 and directions within atol 1e-5. XLA's CPU lowering contracts
    a*b+c into FMAs where the port rounds each op separately, and the scene
    spans ~560 units: one ULP of its coordinates is 6.1e-5, and a bounce
    ray's t_scaled cancels terms of that size;
  - the roofline's summary on the CPU: its keys, counts only.
The tools under tools/ are loaded by path: they are scripts, not a package.
"""

import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import torch

from curry_pbrt_tpu_torch.tools import probe_granularity as PG
from curry_pbrt_tpu_torch.tools import probe_slab_grid as PS
from curry_pbrt_tpu_torch.tools import roofline as RL
from curry_pbrt_tpu_torch.tools.workload import Workload, camera_pixels, load_scene

REPO = Path(__file__).resolve().parents[1]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_slab_grid_plain_matches_the_jax_probe():
    ref = _load_tool("probe_slab_grid").run(interpret=True)  # (1, 512): 2 blocks x 3 slabs
    out = PS.slab_grid(*PS.make_inputs())  # CPU tensors → the plain version
    assert out.shape == ref.shape == (1, 512)
    np.testing.assert_allclose(out.numpy(), ref, rtol=PS.RTOL, atol=0)
    out5, err, _ = PS.run(5, 4, "cpu")
    assert out5.shape == (1, 5 * 256) and err == 0.0


def test_granularity_counts_equal_the_jax_probe():
    jg = _load_tool("probe_granularity")
    wl = Workload(load_scene("mesh10k.pbrt"), "cpu")
    caabb = wl.host.cluster_aabbs
    assert np.isnan(caabb[:, 0]).any()  # padding clusters: NaN boxes
    rng = np.random.default_rng(4)
    n = 3000  # not a multiple of the larger G: the tail group is dropped
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[::11, 1] = 0.0  # an axis-parallel component: inv_d 1e30
    inv_d = (1.0 / np.where(d == 0, np.float32(1e-30), d)).astype(np.float32)
    t_bound = rng.uniform(0.0, 4.0, n).astype(np.float32)
    t_bound[::5] = 0.0  # dead lanes
    je = jg.slab_enter(o, inv_d, t_bound, caabb)
    te = PG.slab_enter(*map(torch.from_numpy, (o, inv_d, t_bound, caabb)))
    np.testing.assert_array_equal(te.numpy(), je)
    assert 0 < je.sum() < je.size
    for g in PG.GROUPS:
        assert PG.flops_at(te, g, 64, ops=jg.TILE_FLOPS) == jg.flops_at(je, g, 64)
    perm = torch.from_numpy(rng.permutation(n))
    whole = {g: PG.tiles_at(te[perm], g) for g in PG.GROUPS}
    chunked = PG.bounce_tiles(*map(torch.from_numpy, (o, d, t_bound)), torch.from_numpy(caabb),
                              {"shuffled": perm}, chunk=1024)["shuffled"]
    assert chunked == whole


def _jax_bounce(js, jtab, o, d, t_max, u2, kw):
    """One bounce of the JAX tools' composition (tools/roofline.py:124-162)
    from given rays and uniforms → (t, row, next o, next d)."""
    from curry_pbrt_tpu.ops import intersect as isect
    from curry_pbrt_tpu.ops import math as m
    from curry_pbrt_tpu.ops.pallas.intersect_kernel import tri_closest_hit_tables

    tris = isect.TriangleArrays(*map(jnp.asarray, (jtab.p0, jtab.p1, jtab.p2, jtab.prim)))
    o, d, t_max = map(jnp.asarray, (o, d, t_max))
    t, idx = tri_closest_hit_tables(o, d, t_max, *map(jnp.asarray, (
        jtab.tris16, jtab.cluster_aabbs, jtab.super_aabbs, jtab.slab_aabbs)), interpret=True, **kw)
    hit = idx >= 0
    hp, hn, _uv, herr = isect.triangle_winner_attributes(
        o, d, t_max, jnp.clip(idx, 0, tris.count - 1), tris)
    local, _pdf = m.cosine_sample_hemisphere(jnp.asarray(u2))
    fx, fy = m.coordinate_system(hn)
    nd = m.to_world(local, fx, fy, hn)
    o2 = jnp.where(hit[:, None], isect.offset_point_by_error(hp, hn, herr, nd), o)
    d2 = jnp.where(hit[:, None], nd, d)
    return tuple(map(np.asarray, (t, idx, o2, d2)))


def test_workload_matches_the_jax_composition():
    from curry_pbrt_tpu.models.camera import generate_rays
    from curry_pbrt_tpu.ops.pallas.aggregate import plan_tri_kernel
    from curry_pbrt_tpu.sceneio.compiler import compile_scene_file as jax_compile

    n, depth = 4096, 3
    js = jax_compile(REPO / "scenes" / "cornell_tex.pbrt")
    wl = Workload(load_scene("cornell_tex.pbrt"), "cpu")
    jtab, block_t, block_r, _small = plan_tri_kernel(js.tris, wl.view)
    np.testing.assert_array_equal(jtab.tris16, wl.host.tris16)
    kw = dict(block_t=block_t, clusters_per_slab=jtab.clusters_per_slab,
              use_supers=jtab.use_supers, block_r=block_r)
    rng = np.random.default_rng(7)
    jitter = rng.random((n, 2), np.float32) - np.float32(0.5)
    uniforms = [rng.random((n, 2), np.float32) for _ in range(depth)]
    px = camera_pixels(wl.scene, n)
    jo, jd = map(np.asarray, generate_rays(js.camera, jnp.asarray(px + jitter), None))

    active = np.ones(n, bool)
    for b in wl.bounces(n, depth, jitter=jitter, uniforms=uniforms):
        o, d, t_max = (x.numpy() for x in (b.o, b.d, b.t_max))
        np.testing.assert_allclose(o, jo, rtol=1e-5, atol=1e-3, err_msg=f"o, bounce {b.index}")
        np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5, err_msg=f"d, bounce {b.index}")
        assert b.active == int(active.sum())
        np.testing.assert_array_equal(t_max, np.where(active, np.float32(1e30), 0.0))
        t, idx, jo, jd = _jax_bounce(js, jtab, o, d, t_max, uniforms[b.index], kw)
        hit = b.row.numpy() >= 0
        np.testing.assert_array_equal(idx >= 0, hit)
        np.testing.assert_allclose(b.t.numpy()[hit], t[hit], rtol=1e-6, atol=1e-4)
        assert hit.sum() > n // 2
        active = active & hit
    assert active.sum() < n  # lanes really die


def test_roofline_summary_on_cpu_has_its_keys():
    s = RL.analyze("cornell_tex.pbrt", 512, 2, "cpu")
    for k in ("scene", "device", "rays", "depth", "block_t", "clusters", "supers", "slabs",
              "tri_test_ops", "box_test_ops", "peak", "total_ms", "achieved_ops_per_s",
              "peak_pct", "bounces"):
        assert k in s, k
    assert s["device"] == "cpu" and s["rays"] == 512 and len(s["bounces"]) == 2
    assert s["peak"] is None and s["total_ms"] is None  # no card: not measured
    for r in s["bounces"]:
        assert r["entered_tiles"] >= r["improved_tiles"] > 0
        assert r["ms"] is None and r["peak_pct"] is None and r["bound_ms"] is None
        assert r["ops"] == RL.tile_ops(r["entered_tiles"], s["block_t"])
    assert "not measured" in RL.report(s)
    assert jax.default_backend() == "cpu"

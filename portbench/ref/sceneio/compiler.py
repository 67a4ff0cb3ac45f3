"""Scene compiler: pbrt directive tree → SceneArrays + differentiable params.

Counterpart of the JAX package's sceneio/compiler.py (copied; only the
params pytree is built from torch tensors). It replaces the reference's
SceneParseStack interpreter (reference src/scene.rs:41-174): instead of building trait
-object graphs, it bakes every shape's object-to-world transform into
world-space SoA arrays (triangles) or per-row object spaces (spheres), packs
materials into compiled lobe constructors, and lights into a `LightArrays`
table. Directive semantics replicated:

  Attribute blocks clone the interpreter state (material/transform/area-light
  /textures/named-materials inherit by value, scene.rs:51-56); Object blocks
  capture primitives for ObjectInstance stamping (scene.rs:57-63,119-140);
  AreaLightSource promotes every subsequent Shape into per-shape lights
  (scene.rs:91-94 — one light PER TRIANGLE, and such primitives carry no
  material so paths terminate on them); transform directives compose as
  new = this · current (scene.rs:154-166); the camera frustum clipper drops
  non-emissive primitives wholly outside the raster volume (scene.rs:107-113,
  camera/perspective.rs:54-78).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.ref.dtypes import Float
from portbench.ref.models.camera import Camera, clip_primitive_bound, make_perspective_camera
from portbench.ref.models.lights import (
    TYPE_AREA_SPH,
    TYPE_AREA_TRI,
    TYPE_DISTANT,
    TYPE_INFINITE,
    TYPE_POINT,
    EnvMap,
    LightArrays,
    build_env_distribution,
)
from portbench.ref.models.materials import CompiledMaterial, compile_material, dedup_key
from portbench.ref.ops import transform as tf
from portbench.ref.ops.intersect import SphereArrays, TriangleArrays
from portbench.ref.sceneio import spd
from portbench.ref.sceneio.parser import BlockSegment, read_scene
from portbench.ref.sceneio.ply import load_ply
from portbench.ref.utils.imageio import read_image


@dataclass
class RenderSettings:
    integrator: str = "path"  # 'path' | 'directlighting'
    max_depth: int = 5
    spp: int = 1
    resolution: Tuple[int, int] = (640, 480)
    filename: str = "curry-pbrt.png"
    seed: int = 0
    # reconstruction filter: 'box' (reference parity — film.rs:4-19 averages
    # per-pixel samples) or 'triangle' (beyond-reference differentiable
    # 2×2 tent splat through ops/film.py:filter_splat's custom VJP)
    filter: str = "box"


@dataclass
class Scene:
    """Compiled scene: static arrays + host metadata. `init_params` is the
    differentiable pytree (material constants, light radiances, textures)."""

    tris: TriangleArrays
    spheres: SphereArrays
    prim_mat: np.ndarray  # (P,) i32, -1 for light prims (host array; the
    prim_light: np.ndarray  # (P,) i32  renderer moves both to its device)
    materials: List[CompiledMaterial]
    material_registry: Dict[str, CompiledMaterial]
    lights: LightArrays
    envs: List[EnvMap]  # one per infinite light (lights.env_id indexes)
    camera: Camera
    settings: RenderSettings
    init_params: dict

    @property
    def n_lights(self) -> int:
        return self.lights.count

    @property
    def env(self) -> Optional[EnvMap]:
        """Back-compat single-map view (first infinite light's map)."""
        return self.envs[0] if self.envs else None


# --------------------------------------------------------------------------
# host-side staging structures


@dataclass
class _PendingPrim:
    kind: str  # 'tri' | 'sphere'
    # tri: (3,3) world verts; sphere: (o2w 4x4, radius)
    tri: Optional[np.ndarray] = None
    o2w: Optional[np.ndarray] = None
    radius: float = 0.0
    mat: Optional[CompiledMaterial] = None
    area_light_L: Optional[np.ndarray] = None  # rgb if emissive

    def bound(self):
        if self.kind == "tri":
            return self.tri.min(axis=0), self.tri.max(axis=0)
        c = self.o2w[:3, 3]
        # conservative AABB of transformed sphere
        r = self.radius * float(np.abs(self.o2w[:3, :3]).sum(axis=1).max())
        return c - r, c + r


@dataclass
class _State:
    """One level of the attribute stack (cloned per block)."""

    material: Optional[CompiledMaterial] = None
    transform: Optional[np.ndarray] = None
    area_light_L: Optional[np.ndarray] = None
    textures: Dict[str, str] = field(default_factory=dict)  # name -> store key
    named_materials: Dict[str, CompiledMaterial] = field(default_factory=dict)
    object_name: Optional[str] = None

    def clone(self) -> "_State":
        return _State(
            self.material,
            None if self.transform is None else self.transform.copy(),
            self.area_light_L,
            dict(self.textures),
            dict(self.named_materials),
            self.object_name,
        )


class _Compiler:
    def __init__(self, camera: Optional[Camera]):
        self.camera = camera
        self.prims: List[_PendingPrim] = []
        self.objects: Dict[str, List[_PendingPrim]] = {}
        self.materials: List[CompiledMaterial] = []
        self.mat_dedup: Dict[tuple, CompiledMaterial] = {}
        self.registry: Dict[str, CompiledMaterial] = {}
        self.texture_store: Dict[str, np.ndarray] = {}
        self.point_lights: List[Tuple[np.ndarray, np.ndarray]] = []  # (pos, I)
        self.distant_lights: List[Tuple[np.ndarray, np.ndarray]] = []  # (w, L)
        self.infinite_lights: List[Tuple[Optional[np.ndarray], np.ndarray]] = []  # (map, tint)

    # -- materials ---------------------------------------------------------

    def intern_material(self, kind: str, ps, state: "_State") -> CompiledMaterial:
        mat = compile_material(kind, ps, mat_id=len(self.materials))
        self._bind_scoped_textures(mat, state)
        key = dedup_key(mat)
        if key in self.mat_dedup:
            return self.mat_dedup[key]
        self.materials.append(mat)
        self.mat_dedup[key] = mat
        return mat

    def _bind_scoped_textures(self, mat: CompiledMaterial, state: "_State"):
        """Resolve texture NAMES to texture-store KEYS using the attribute
        stack's scoped texture map, at material-compile time — the reference's
        per-block TextureMap semantics (scene.rs:51-56): a name rebound in a
        sibling Attribute scope must not affect this material. mix's
        namedmaterial1/2 slots hold material names, not textures."""
        from portbench.ref.models.materials import TexRef

        for slot, ref in list(mat.refs.items()):
            if slot in ("namedmaterial1", "namedmaterial2") or ref.kind != "texture":
                continue
            key = state.textures.get(ref.tex)
            if key is None:
                raise ValueError(
                    f"material {mat.kind!r} references undefined texture {ref.tex!r}"
                )
            mat.refs[slot] = TexRef.texture(key)

    # -- directive walk ----------------------------------------------------

    def parse_block(self, segments: List[BlockSegment], state: _State):
        for seg in segments:
            self.parse_segment(seg, state)

    def parse_segment(self, seg: BlockSegment, state: _State):
        if seg.is_block:
            child = state.clone()
            if seg.block_type == "Object":
                child.object_name = seg.block_name
                self.objects.setdefault(seg.block_name, [])
            elif seg.block_type != "Attribute":
                raise ValueError(f"unexpected block {seg.block_type!r} in World")
            self.parse_block(seg.children, child)
            return

        ot, ps = seg.object_type, seg.properties
        if ot == "Material":
            kind = ps.get_name()
            state.material = self.intern_material_with_registry(kind, ps, state)
        elif ot == "MakeNamedMaterial":
            name = ps.get_name()
            kind = ps.get_string("type")
            state.named_materials[name] = self.intern_material_with_registry(kind, ps, state)
        elif ot == "Shape":
            self.add_shapes(ps, state)
        elif ot == "ObjectInstance":
            name = ps.get_name()
            for prim in self.objects.get(name, []):
                self.add_prim(self.transform_prim(prim, state.transform))
        elif ot == "LightSource":
            self.add_light_source(ps, state)
        elif ot == "AreaLightSource":
            if ps.get_name() != "diffuse":
                raise ValueError(f"unknown area light {ps.get_name()!r}")
            state.area_light_L = _get_rgb(ps, "L", default=np.ones(3))
        elif ot == "Texture":
            self.add_texture(ps, state)
        elif ot == "Transform":
            state.transform = _parse_transform_directive(ot, ps)
        elif ot in ("Translate", "Rotate", "Scale", "LookAt", "ConcatTransform"):
            this = _parse_transform_directive(ot, ps)
            state.transform = (
                this if state.transform is None else tf.compose(this, state.transform)
            )
        elif ot == "ReverseOrientation":
            pass  # accepted, no-op (reference has no normal flipping either)
        else:
            import logging

            logging.getLogger(__name__).error("unknown directive %s", ot)

    def intern_material_with_registry(self, kind, ps, state) -> CompiledMaterial:
        if kind == "mix":
            mat = compile_material(kind, ps, mat_id=len(self.materials))
            self._bind_scoped_textures(mat, state)  # textured `amount`
            # resolve the named materials NOW into the global registry
            for slot in ("namedmaterial1", "namedmaterial2"):
                name = mat.refs[slot].tex
                self.registry[name] = state.named_materials[name]
            self.materials.append(mat)
            return mat
        return self.intern_material(kind, ps, state)

    # -- shapes ------------------------------------------------------------

    def add_shapes(self, ps, state: _State):
        name = ps.get_name()
        prims: List[_PendingPrim] = []
        if name == "sphere":
            radius = ps.get_float("radius", 1.0)
            prims.append(_PendingPrim("sphere", o2w=tf.identity(), radius=radius))
        elif name == "trianglemesh":
            indices = ps.get_ints("indices")
            pvals = ps.get_floats("P")
            verts = np.asarray(pvals, np.float32).reshape(-1, 3)
            for i in range(0, len(indices), 3):
                tri = verts[[indices[i], indices[i + 1], indices[i + 2]]]
                prims.append(_PendingPrim("tri", tri=tri.copy()))
        elif name == "plymesh":
            path = ps.get_path("filename")
            idx, verts = load_ply(path)
            for i in range(0, len(idx), 3):
                tri = verts[[idx[i], idx[i + 1], idx[i + 2]]]
                prims.append(_PendingPrim("tri", tri=tri.astype(np.float32)))
        else:
            raise ValueError(f"unknown shape {name!r}")

        for prim in prims:
            prim = self.transform_prim(prim, state.transform)
            if state.area_light_L is not None:
                prim.area_light_L = state.area_light_L
            else:
                if state.material is None:
                    raise ValueError("Shape before any Material directive")
                prim.mat = state.material
            if state.object_name is not None:
                self.objects[state.object_name].append(prim)
            else:
                self.add_prim(prim)

    def transform_prim(self, prim: _PendingPrim, transform) -> _PendingPrim:
        import copy

        prim = copy.copy(prim)
        if transform is None:
            return prim
        if prim.kind == "tri":
            prim.tri = tf.apply_p(transform, prim.tri).astype(np.float32)
        else:
            prim.o2w = tf.compose(transform, prim.o2w)
        return prim

    def add_prim(self, prim: _PendingPrim):
        if self.camera is not None and prim.area_light_L is None:
            bmin, bmax = prim.bound()
            if clip_primitive_bound(self.camera, bmin, bmax, is_light=False):
                return
        self.prims.append(prim)

    # -- lights ------------------------------------------------------------

    def add_light_source(self, ps, state: _State):
        kind = ps.get_name()
        t = state.transform
        if kind == "point":
            i = _get_rgb(ps, "I", default=np.ones(3))
            pos = np.zeros(3, np.float32)
            if t is not None:
                pos = tf.apply_p(t, pos[None])[0]
            self.point_lights.append((pos.astype(np.float32), i))
        elif kind == "distant":
            L = _get_rgb(ps, "L", default=np.ones(3))
            frm = ps.get_floats("from")
            to = ps.get_floats("to")
            if frm is not None:
                w = np.asarray(to, np.float64) - np.asarray(frm, np.float64)
            else:
                w = np.array([0.0, 0.0, -1.0])
            if t is not None:
                w = tf.apply_v(t, w.astype(np.float32)[None])[0]
            w = w / np.linalg.norm(w)
            self.distant_lights.append((w.astype(np.float32), L))
        elif kind == "infinite":
            mp = ps.get_path("mapname")
            img = None if mp is None else read_image(mp)
            tint = _get_rgb(ps, "L", default=np.ones(3))
            self.infinite_lights.append((img, tint))
        else:
            raise ValueError(f"unknown light {kind!r}")

    # -- textures ----------------------------------------------------------

    def add_texture(self, ps, state: _State):
        strings = ps.bare_strings()
        name, tex_type = strings[0], strings[1]
        path = ps.get_path("filename")
        img = read_image(path)
        if tex_type == "spectrum":
            # inverse sRGB gamma in numpy (host), once at compile time
            from portbench.ref.ops.math import inverse_gamma_correct

            img = inverse_gamma_correct(img.astype(np.float64)).astype(np.float32)
        key = f"{name}#{tex_type}#{len(self.texture_store)}"
        self.texture_store[key] = img.astype(np.float32)
        state.textures[name] = key


def _get_rgb(ps, name, default):
    p = ps.find(name)
    if p is None:
        return np.asarray(default, np.float32)
    vals = [float(t.value) for t in p.values]
    if p.type_name == "rgb" or p.type_name == "color":
        return np.asarray(vals[:3], np.float32)
    if p.type_name == "spectrum":
        return np.asarray(spd.spd_to_rgb(vals), np.float32)
    if p.type_name == "blackbody":
        raise ValueError("blackbody spectra not supported")
    return np.asarray(vals[:3], np.float32)


def _parse_transform_directive(ot: str, ps) -> np.ndarray:
    f = ps.bare_floats()
    if ot == "Translate":
        return tf.translate(f[:3])
    if ot == "Scale":
        return tf.scale(f[:3])
    if ot == "Rotate":
        return tf.rotate(f[0], f[1:4])
    if ot == "LookAt":
        return tf.look_at(f[0:3], f[3:6], f[6:9])
    if ot in ("Transform", "ConcatTransform"):
        # column-major 16 floats (nalgebra from_vec — transform.rs:171-183)
        return np.asarray(f[:16], np.float64).reshape(4, 4).T.astype(Float)
    raise ValueError(ot)


# --------------------------------------------------------------------------
# top level


def compile_scene_file(path, overrides: Optional[dict] = None) -> Scene:
    """Parse + compile a .pbrt file (render_from_file front half,
    reference src/render.rs:63-78)."""
    segments = read_scene(path)
    return compile_segments(segments, overrides or {})


def compile_scene_string(text: str, base_dir=".", overrides: Optional[dict] = None) -> Scene:
    from portbench.ref.sceneio.lexer import tokenize_string
    from portbench.ref.sceneio.parser import segments_from_tokens

    toks = tokenize_string(text, str(Path(base_dir) / "<inline>.pbrt"))
    return compile_segments(segments_from_tokens(toks), overrides or {})


def compile_segments(segments: List[BlockSegment], overrides: dict) -> Scene:
    settings = RenderSettings()

    # pre-world: camera transform, camera, sampler, film, integrator
    cam_transform = None
    cam_fov, lens_radius, focal_distance = 90.0, 0.0, 1e6
    world = None
    for seg in segments:
        if seg.is_block:
            if seg.block_type == "World" and world is None:
                world = seg
            continue
        ot, ps = seg.object_type, seg.properties
        if ot in ("Translate", "Rotate", "Scale", "LookAt", "Transform", "ConcatTransform"):
            if cam_transform is None:
                cam_transform = _parse_transform_directive(ot, ps)
            else:
                cam_transform = tf.compose(_parse_transform_directive(ot, ps), cam_transform)
        elif ot == "Camera":
            assert ps.get_name() == "perspective", "only perspective cameras supported"
            cam_fov = ps.get_float("fov", 90.0)
            lr = ps.get_float("lensradius", None)
            if lr is not None:
                lens_radius = lr
            focal_distance = ps.get_float("focaldistance", 1e6)
        elif ot == "Sampler":
            assert ps.get_name() == "halton", "only the halton sampler is supported"
            settings.spp = ps.get_int("pixelsamples", 1)
        elif ot == "Film":
            settings.resolution = (
                ps.get_int("xresolution", 640),
                ps.get_int("yresolution", 480),
            )
            settings.filename = ps.get_string("filename", "curry-pbrt.png")
            settings.filter = ps.get_string("filter", "box")
        elif ot == "Integrator":
            settings.integrator = ps.get_name()
            settings.max_depth = ps.get_int("maxdepth", 5)

    settings.spp = int(overrides.get("spp", settings.spp))
    settings.max_depth = int(overrides.get("max_depth", settings.max_depth))
    settings.seed = int(overrides.get("seed", 0))
    if "resolution" in overrides:
        settings.resolution = tuple(overrides["resolution"])
    if "integrator" in overrides:
        settings.integrator = overrides["integrator"]
    if "filter" in overrides:
        settings.filter = overrides["filter"]
    if settings.filter not in ("box", "triangle"):
        raise ValueError(
            f"unsupported film filter {settings.filter!r} (box|triangle)"
        )

    camera_to_world = None if cam_transform is None else tf.inverse(cam_transform)
    camera = make_perspective_camera(
        cam_fov, settings.resolution, camera_to_world, lens_radius, focal_distance
    )

    comp = _Compiler(camera if overrides.get("clip", True) else None)
    if world is not None:
        comp.parse_block(world.children, _State())
    return _assemble(comp, camera, settings)


def _assemble(comp: _Compiler, camera: Camera, settings: RenderSettings) -> Scene:
    # primitives → SoA tables + light rows
    tri_rows, sph_rows = [], []
    prim_mat, prim_light = [], []
    light_rows = []  # dicts
    env_imgs = []  # one image per infinite light, indexed by row env_id

    def new_prim(mat_id: int, light_id: int) -> int:
        prim_mat.append(mat_id)
        prim_light.append(light_id)
        return len(prim_mat) - 1

    for prim in comp.prims:
        if prim.area_light_L is not None:
            light_id = len(light_rows)
            row = dict(L=prim.area_light_L)
            if prim.kind == "tri":
                row.update(type=TYPE_AREA_TRI, tri=prim.tri)
            else:
                row.update(type=TYPE_AREA_SPH, o2w=prim.o2w, radius=prim.radius)
            light_rows.append(row)
            pid = new_prim(-1, light_id)
        else:
            pid = new_prim(prim.mat.mat_id, -1)
        if prim.kind == "tri":
            tri_rows.append((prim.tri, pid))
        else:
            sph_rows.append((prim.o2w, prim.radius, pid))

    for pos, i in comp.point_lights:
        light_rows.append(dict(type=TYPE_POINT, vec=pos, L=i))
    for w, L in comp.distant_lights:
        light_rows.append(dict(type=TYPE_DISTANT, vec=w, L=L))
    for img, tint in comp.infinite_lights:
        # the reference supports any number of infinite lights, each with
        # its own map + importance table (light/mod.rs:43-64,
        # infinite_area.rs:9-73); each gets its own env_id row here
        if img is None:
            img = np.ones((1, 1, 3), np.float32)
        light_rows.append(dict(type=TYPE_INFINITE, L=tint, env_id=len(env_imgs)))
        env_imgs.append(img)

    # --- device arrays
    T = max(len(tri_rows), 1)
    tri_p = np.zeros((3, T, 3), np.float32)
    tri_prim = np.full((T,), -1, np.int32)
    for i, (tri, pid) in enumerate(tri_rows):
        tri_p[:, i, :] = tri
        tri_prim[i] = pid
    S = max(len(sph_rows), 1)
    sph_o2w = np.tile(np.eye(4, dtype=np.float32), (S, 1, 1))
    sph_radius = np.zeros((S,), np.float32)
    sph_prim = np.full((S,), -1, np.int32)
    for i, (o2w, radius, pid) in enumerate(sph_rows):
        sph_o2w[i] = o2w
        sph_radius[i] = radius
        sph_prim[i] = pid
    sph_w2o = np.linalg.inv(sph_o2w.astype(np.float64)).astype(np.float32)

    tris = TriangleArrays(
        tri_p[0], tri_p[1], tri_p[2],
        tri_prim,
    )
    spheres = SphereArrays(
        sph_o2w, sph_w2o, sph_radius,
        sph_prim,
    )

    # --- light table
    L = max(len(light_rows), 1)
    lt = dict(
        type_id=np.full((L,), -1, np.int32),
        is_delta=np.zeros((L,), bool),
        vec=np.zeros((L, 3), np.float32),
        tri_p0=np.zeros((L, 3), np.float32),
        tri_p1=np.zeros((L, 3), np.float32),
        tri_p2=np.zeros((L, 3), np.float32),
        sph_o2w=np.tile(np.eye(4, dtype=np.float32), (L, 1, 1)),
        sph_w2o=np.tile(np.eye(4, dtype=np.float32), (L, 1, 1)),
        sph_radius=np.zeros((L,), np.float32),
        area=np.ones((L,), np.float32),
        env_id=np.full((L,), -1, np.int32),
    )
    light_L = np.zeros((L, 3), np.float32)
    for i, row in enumerate(light_rows):
        lt["type_id"][i] = row["type"]
        light_L[i] = row["L"]
        if "env_id" in row:
            lt["env_id"][i] = row["env_id"]
        t = row["type"]
        if t in (TYPE_POINT, TYPE_DISTANT):
            lt["is_delta"][i] = True
            lt["vec"][i] = row["vec"]
        elif t == TYPE_AREA_TRI:
            tri = row["tri"]
            lt["tri_p0"][i], lt["tri_p1"][i], lt["tri_p2"][i] = tri
            lt["area"][i] = 0.5 * np.linalg.norm(
                np.cross(tri[1] - tri[0], tri[2] - tri[0])
            )
        elif t == TYPE_AREA_SPH:
            lt["sph_o2w"][i] = row["o2w"]
            lt["sph_w2o"][i] = np.linalg.inv(row["o2w"].astype(np.float64)).astype(
                np.float32
            )
            lt["sph_radius"][i] = row["radius"]
            lt["area"][i] = 4.0 * np.pi * row["radius"] ** 2
    lights = LightArrays(**lt)  # host numpy; the renderer moves it to its device

    envs = [
        EnvMap(image=img.astype(np.float32), dist=build_env_distribution(img))
        for img in env_imgs
    ]

    # --- params pytree
    params = {
        "materials": {str(m.mat_id): m.param_values() for m in comp.materials},
        "textures": {k: torch.from_numpy(v) for k, v in comp.texture_store.items()},
        "light_L": torch.from_numpy(light_L),
    }

    return Scene(
        tris=tris,
        spheres=spheres,
        prim_mat=np.asarray(prim_mat + [-1], np.int32)[: max(len(prim_mat), 1)],
        prim_light=np.asarray(prim_light + [-1], np.int32)[: max(len(prim_light), 1)],
        materials=comp.materials,
        material_registry=comp.registry,
        lights=lights,
        envs=envs,
        camera=camera,
        settings=settings,
        init_params=params,
    )

"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc and ctypes.

The sources are compiled at first use into build/kernels/ under the repo
root, for Hopper only (sm_90a), as a shared library with a plain C
interface — no PyTorch headers, so a build takes seconds, not minutes: one
nvcc per source, all started together, then one link. The library name
carries a hash of the sources and flags, so an edited source is never
served from a stale build.

Flags that are decisions, not defaults:
  -fmad=false   no contraction of a*b+c into an FMA: the watertight
                triangle test's error bounds assume separately rounded ops,
                and the plain PyTorch versions (and the JAX reference)
                round each op separately. chip_smoke.py pins this by
                requiring the kernels' t to be bit-equal to the plain
                versions'.
  -prec-div=true -prec-sqrt=true (nvcc's defaults without fast math, made
                explicit): IEEE-rounded division and square root, as the
                sphere test's quadratic and the plain versions round them.
  no --use_fast_math.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = GENCODE + (
    "-std=c++17", "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libcurry_kernels_{h.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the shared library (skipped when a library
    built from the same sources and flags exists). verbose adds
    `-Xptxas -v` and prints nvcc's output (registers, spills)."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_suffix(f".{src.stem}.o") for src in cu]
    ptxas = ["-Xptxas", "-v"] if verbose else []
    procs = [subprocess.Popen([nvcc_path(), *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(cu, objs)]
    logs = [p.communicate()[0] for p in procs]
    for src, p, log in zip(cu, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({p.returncode}):\n{log}")
    if verbose:
        print("".join(logs), end="")
    res = subprocess.run([nvcc_path(), *GENCODE, "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# o, d, t_max, prims, caabb, saabb, slab; n, block, clusters_per_slab,
# n_slabs, use_supers; g2, g3, g5, t_scale (intersect.cuh CURRY_TABLE_ARGS)
_TABLE_ARGS = [_P] * 7 + [_I] * 5 + [_F] * 4
# Every extern "C" entry point of csrc/*.cu and its argument types; each
# returns a cudaError_t as int.
ENTRY_POINTS = {
    # intersect_warp.cu: t_out, row_out, entered_out, improved_out / hit_out; stream
    "curry_tri_closest_hit_warp": _TABLE_ARGS + [_P] * 5,
    "curry_tri_any_hit_warp": _TABLE_ARGS + [_P] * 2,
    "curry_sphere_closest_hit_warp": _TABLE_ARGS + [_P] * 3,  # t_out, row_out; stream
    "curry_sphere_any_hit_warp": _TABLE_ARGS + [_P] * 2,
    # intersect.cu, the same signatures
    "curry_tri_closest_hit_thread": _TABLE_ARGS + [_P] * 5,
    "curry_tri_any_hit_thread": _TABLE_ARGS + [_P] * 2,
    "curry_sphere_closest_hit_thread": _TABLE_ARGS + [_P] * 3,
    "curry_sphere_any_hit_thread": _TABLE_ARGS + [_P] * 2,
    # intersect_group.cu
    "curry_tri_closest_hit_groups": _TABLE_ARGS + [_P] * 3,
    "curry_tri_any_hit_groups": _TABLE_ARGS + [_P] * 2,
    # slab_grid.cu: tab, rays, slabs; n_slabs, slab_rows, block_rays, n; out, stream
    "curry_slab_grid": [_P] * 3 + [_I] * 4 + [_P] * 2,
}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    return lib

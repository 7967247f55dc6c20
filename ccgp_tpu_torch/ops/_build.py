"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own `nvcc` process, all of them
started together, and the objects are linked into ONE shared library with
a plain C interface, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <tmp>/<name>.o csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o _build/libccgp_kernels_<hash>.so <tmp>/*.o

No PyTorch headers are included, so a build takes seconds. The output goes
to `ccgp_tpu_torch/_build/` under a name keyed by a hash of the sources and
flags: it is rebuilt only when they change. Fast-math is deliberately off:
the kernels' NaN-as-rejection dataflow and rsqrt precision rely on IEEE
behaviour.

Every C entry point takes its pointers and the CUDA stream as `void*` and
returns `cudaGetLastError()` right after its launch; `check` raises on a
non-zero code. Nothing is built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C entry points: name -> argtypes (restype is always int)
_SIGNATURES = {
    "ccgp_threefry_split_chain": [_P, _P, _P, _P, _I, _P],
    "ccgp_mh_rounds_f32": [_P] * 11 + [_I] * 5 + [_D, _P],
    "ccgp_mh_rounds_f64": [_P] * 11 + [_I] * 5 + [_D, _P],
    # grams, y, q, chol, wy, wo, B, n, factors, jitter, stream
    "ccgp_chol_lanes_f32": [_P] * 6 + [_I] * 3 + [_D, _P],
    "ccgp_chol_lanes_f64": [_P] * 6 + [_I] * 3 + [_D, _P],
    # grams, y, q, ws, n, K, jitter, stream
    "ccgp_chol_quad_smallk_f32": [_P] * 4 + [_I] * 2 + [_D, _P],
    "ccgp_chol_quad_smallk_f64": [_P] * 4 + [_I] * 2 + [_D, _P],
    # x, y, r1, r2, p, q, ws, n, d, K, jitter, stream
    "ccgp_mix_quad_smallk_f32": [_P] * 7 + [_I] * 3 + [_D, _P],
    "ccgp_mix_quad_smallk_f64": [_P] * 7 + [_I] * 3 + [_D, _P],
    # x, y, r1, r2, p, extra, log_scale, cands, st, log_u, z, vb, info, ws,
    # n, d, dim, K, jitter, stream
    "ccgp_mix_mh_round_f32": [_P] * 14 + [_I] * 4 + [_D, _P],
    "ccgp_mix_mh_round_f64": [_P] * 14 + [_I] * 4 + [_D, _P],
}

def _sources():
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _run_all(cmds) -> None:
    """Run the commands in parallel, wait for every one, raise if any
    failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (so, se) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(c)}"
                               f"\n{so}\n{se}")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libccgp_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            srcs = [p for p in _sources() if p.suffix == ".cu"]
            objs = [os.path.join(tmp, p.stem + ".o") for p in srcs]
            _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                      for p, o in zip(srcs, objs)])
            so = os.path.join(tmp, "lib.so")
            _run_all([[nvcc, *ARCH, "-shared", "-o", so, *objs]])
            os.replace(so, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def ptr(t) -> int:
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream(device) -> int:
    """The current PyTorch CUDA stream of `device`, as a raw handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream

"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use, ``nvcc`` compiles each source into a shared library with a
plain C interface for ``sm_90a`` (Hopper), under
``event_utils_tpu_torch/_build/<hash of the sources and flags>/``, and the
library is loaded with ``ctypes``. The hash keys the cache, so an edited
source rebuilds and an unchanged one loads at once. Nothing here falls
back: a missing ``nvcc`` or a failed build raises ``NativeBuildError``.

The build needs only the checkout and the CUDA toolkit (``nvcc`` on
``PATH``, or under ``$CUDA_HOME/bin``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from ..errors import NativeBuildError

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default home
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v") + ARCH_FLAGS

# C signatures: every pointer and the stream are c_void_p (ctypes would
# otherwise pass a Python int as a 32-bit int and cut the pointer).
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
SIGNATURES = {
    "scatter_kernels": {
        "voxel_tiles_scatter": (_P, _P, _P, _P, _L, _L, _I, _I, _I, _P, _P),
        "voxel_scatter_batched": (_P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _P,
                                  _P),
        "voxel_scatter_batched_vector": (_P, _P, _P, _P, _L, _L, _I, _I, _I,
                                         _I, _I, _P, _P, _P),
        "voxel_scatter_batched_private": (_P, _P, _P, _P, _L, _L, _I, _I,
                                          _I, _I, _P, _P),
        "flat_scatter": (_P, _P, _L, _I, _L, _P, _P),
        "flat_scatter_vector": (_P, _P, _L, _I, _L, _I, _P, _P, _P),
        "bilinear_patches_scatter": (_P, _P, _P, _L, _L, _I, _I, _I, _P, _P),
        "bilinear_patches_scatter_direct": (_P, _P, _P, _L, _L, _I, _I, _I,
                                            _P, _P),
        "bilinear_scatter_batched": (_P, _P, _P, _L, _L, _L, _I, _I, _I, _P,
                                     _P),
        "bilinear_scatter_batched_private": (_P, _P, _P, _L, _L, _L, _I, _I,
                                             _I, _P, _I, _P),
        "voxel_tiles_scatter_private": (_P, _P, _P, _P, _L, _L, _I, _I, _I,
                                        _P, _P),
        "bilinear_scatter_batched_vector": (_P, _P, _P, _L, _L, _L, _I, _I,
                                            _I, _I, _P, _P, _P),
    },
    "patch_loss_kernels": {
        "patch_variance_vg": (_P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _I,
                              _I, _F, _F, _F, _I, _P, _P, _P),
    },
}

_lock = threading.Lock()
_libs: dict = {}
# seconds spent compiling and the ptxas report, per library, from this process
build_log: dict = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(str(Path(home) / "bin" / "nvcc"))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise NativeBuildError(
        "nvcc not found (PATH, $CUDA_HOME/bin); the CUDA kernels are built "
        "from csrc/ at first use on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / key / f"lib{name}.so"


def _compile(name: str) -> Path:
    out = _lib_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_log[name] = {"seconds": time.perf_counter() - t0,
                       "ptxas": proc.stderr}
    return out


def _load(name: str, path: Path):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def build_all() -> dict:
    """Compile every source (one ``nvcc`` each, all started together) and
    load the libraries. Returns ``{name: ctypes.CDLL}``."""
    with _lock:
        todo = [n for n in SIGNATURES if n not in _libs]
        if todo:
            with ThreadPoolExecutor(max_workers=len(todo)) as ex:
                paths = dict(zip(todo, ex.map(_compile, todo)))
            for n in todo:
                _libs[n] = _load(n, paths[n])
        return dict(_libs)


def library(name: str = "scatter_kernels"):
    """The loaded ``ctypes`` library ``name``, built on first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_all()[name]


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise NativeBuildError(f"{what}: CUDA error {rc} at launch")

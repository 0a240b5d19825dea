"""Build and load the port's CUDA kernels.

Every `.cu` file under `aqp_tpu_torch/csrc/` is compiled by ONE `nvcc` call
into one shared library with a plain C interface, which `ctypes` loads.  No
PyTorch header is included and PyTorch's extension tooling is not used: such a
build takes minutes where this one takes seconds, and it needs `ninja`.

The library is named after a hash of the sources and the flags, so a
changed source builds anew and an unchanged one loads at once.  It is
written under a temporary name and moved into place with `os.replace`, so
an interrupted build leaves no half-written library and no lock file.

The build happens at first use (`load()`), never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# No --use_fast_math: rho3's fine bucket depends on exact float32 rounding.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of every exported function: without them ctypes passes a Python
# int as a 32-bit C int and cuts a device pointer.
SIGNATURES = {
    "rho3_error_string": ([_I], ctypes.c_char_p),
    "rho3_k1": ([_P, _P, _LL, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P], _I),
    "rho3_k2": ([_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P],
                _I),
    "rho3_k3_smem": ([_I, _I], _LL),
    "rho3_k3_max_cap": ([], _I),
    "rho3_k3": ([_P, _P, _P, _I, _I, _I, _I, _P, _P, _P], _I),
}


def find_nvcc() -> str:
    """Path of nvcc from CUDA_HOME, else PATH, else the toolkit's default
    install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin);"
        " the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libaqp_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is not built yet.  Returns (path, seconds
    spent compiling; 0.0 when it was already there)."""
    out = library_path()
    if out.is_file():
        return out, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cu = [str(p) for p in sources() if p.suffix == ".cu"]
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    print(f"[aqp_tpu_torch] built {out.name} in {secs:.2f} s",
          file=sys.stderr, flush=True)
    return out, secs


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every exported signature."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if err != 0:
        msg = lib.rho3_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

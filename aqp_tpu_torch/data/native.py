"""Host-side relation generators in C++ (counterpart of
aqp_tpu/data/native.py): the ctypes bridge to native/aqp_native.cpp.

For relations too large for device memory (the streaming join's S,
ops/streamjoin.py) the keys are made on the host, by the same seeded
generators as the reference's library, and copied to the card in chunks.
`gen_pk_host`, `gen_fk_host` and `gen_zipf_host` return host numpy int32
arrays.

The library is built from the repository's `native/aqp_native.cpp` at
first use, with the host C++ compiler (`$CXX`, else g++), into
`aqp_tpu_torch/_build/`, named by a hash of the source and the flags.  It
is written under a temporary name and moved into place, so processes that
build at once never load half a file.  The tracked `native/` directory is
neither built into nor read from for a library: its prebuilt one was built
with -march=native on another host.  There is no numpy fallback: the
reference's gives other keys than its library, so without a working
compiler these functions raise with the compiler's message.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "aqp_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-std=c++20", "-shared", "-fPIC", "-pthread")


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path(build_dir=None) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((_compiler(),) + CXX_FLAGS).encode())
    return Path(build_dir or BUILD_DIR) / f"libaqp_native_{h.hexdigest()[:16]}.so"


def build(build_dir=None) -> Path:
    """Compile the library into build_dir (default BUILD_DIR) unless it is
    there; returns its path.  Raises with the compiler's message when it
    is missing or fails."""
    out = library_path(build_dir)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except OSError as e:
            raise RuntimeError(f"cannot build {SOURCE.name}: {' '.join(cmd)}"
                               f": {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"cannot build {SOURCE.name} "
                               f"({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.cache
def _load() -> ctypes.CDLL:
    """Build if needed, load, and declare the three generators."""
    lib = ctypes.CDLL(str(build()))
    lib.aqp_gen_pk.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_uint64]
    lib.aqp_gen_fk.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64]
    lib.aqp_gen_zipf.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_uint64]
    for fn in (lib.aqp_gen_pk, lib.aqp_gen_fk, lib.aqp_gen_zipf):
        fn.restype = None
    return lib


def _buf(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def gen_pk_host(n: int, seed: int = 11111) -> np.ndarray:
    """Dense unique keys {1..n}, shuffled."""
    out = np.empty(n, np.int32)
    _load().aqp_gen_pk(_buf(out), n, seed)
    return out


def gen_fk_host(n: int, maxid: int, seed: int = 22222) -> np.ndarray:
    """Tiled foreign keys over {1..maxid}: n // maxid shuffled copies,
    then a shuffled prefix of one more."""
    if maxid < 1:
        raise ValueError(f"maxid must be at least 1, got {maxid}")
    out = np.empty(n, np.int32)
    _load().aqp_gen_fk(_buf(out), n, maxid, seed)
    return out


def gen_zipf_host(n: int, alphabet: int, z: float,
                  seed: int = 22222) -> np.ndarray:
    """Zipf(z) keys over a shuffled alphabet {1..alphabet}."""
    if alphabet < 1:
        raise ValueError(f"alphabet must be at least 1, got {alphabet}")
    out = np.empty(n, np.int32)
    _load().aqp_gen_zipf(_buf(out), n, alphabet, z, seed)
    return out

"""Build and load the port's CUDA kernels.

Every `.cu` file under `aqp_tpu_torch/csrc/` is compiled by its own `nvcc`
process, all started together, and one more `nvcc` links the objects into
one shared library with a plain C interface, which `ctypes` loads.  No
PyTorch header is included and PyTorch's extension tooling is not used: such a
build takes minutes where this one takes seconds, and it needs `ninja`.

The library is named after a hash of the sources and the flags, so a
changed source builds anew and an unchanged one loads at once.  It is
written under a temporary name and moved into place with `os.replace`, so
an interrupted build leaves no half-written library and no lock file.
Each compile runs with `-Xptxas -v`; what ptxas says of each source's
kernels (registers, shared memory, spill stores and loads) is kept beside
the library and read back by `ptxas_report`.

The build happens at first use (`load()`), never at import.  The helpers
at the end are what every kernel wrapper uses around a launch: the device
rule (a CPU tensor takes the plain version, a CUDA tensor the kernel,
anything else raises), argument checks, pointers and the current stream.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# No --use_fast_math: rho3's fine bucket depends on exact float32 rounding.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# ptxas's report of each kernel on the compile's stderr
REPORT_FLAGS = ("-Xptxas", "-v")

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
    "rho3_max_slot": ([_I], _I),
    "rho3_max_group": ([], _I),
    "rho3_k3_max_cap": ([], _I),
    "rho3_k3": ([_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P], _I),
    "rho3_k3m": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                  _P], _I),
    "compact_windows": ([_P, _I, _LL, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                         _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
                        _I),
    "scatter_segments": ([_P, _P, _P, _P, _P, _I, _LL, _LL, _I, _P, _P, _P],
                         _I),
    "scan_reduce": ([_P, _LL, _I, _I, _I, _P, _P], _I),
    "scan_bitvector": ([_P, _LL, _I, _I, _P, _P], _I),
    "aggpipe_k3agg": ([_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                       _P, _P, _P, _P, _P, _P, _P, _P, _P, _P], _I),
    "nphj_k3two": ([_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                    _P, _P], _I),
    "nphj_k3two_mat": ([_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P], _I),
    "rstats_max_h": ([], _I),
    "rstats": ([_P, _P, _LL, _P, _I, _P, _P], _I),
    "sort_blocks": ([_P, _P, _LL, _I, _P, _P, _P, _P], _I),
    "sort_hist": ([_P, _P, _LL, _I, _I, _F, _P, _P, _P, _P, _P], _I),
    "sort_tile_plan": ([_P, _P, _LL, _P, _P, _P, _P], _I),
    "sort_kernel_launches": ([_P], None),
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


def library_path(build_dir: Optional[Path] = None) -> Path:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + REPORT_FLAGS).encode())
    name = f"libaqp_kernels_{h.hexdigest()[:16]}.so"
    return (build_dir or BUILD_DIR) / name


def report_path(build_dir: Optional[Path] = None) -> Path:
    """Where build() keeps the library's ptxas report (JSON: each source's
    lines)."""
    return library_path(build_dir).with_suffix(".ptxas.json")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands side by side; raise with the first failure's
    output.  Returns each command's stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")
    return [err for _, err in outs]


def build(build_dir: Optional[Path] = None) -> tuple[Path, float]:
    """Compile the library into build_dir (default BUILD_DIR) if it is not
    built there yet.  Returns (path, seconds spent compiling; 0.0 when it
    was already there)."""
    out = library_path(build_dir)
    if out.is_file():
        return out, 0.0
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    report = report_path(build_dir)
    tmp_report = report.with_name(f"{report.name}.{os.getpid()}.tmp")
    cu = [p for p in sources() if p.suffix == ".cu"]
    objs = [out.parent / f"{tag}.{p.stem}.o" for p in cu]
    t0 = time.perf_counter()
    try:
        errs = _run_all([[nvcc, *NVCC_FLAGS, *REPORT_FLAGS, "-I",
                          str(CSRC_DIR), "-c", str(src), "-o", str(obj)]
                         for src, obj in zip(cu, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]])
        tmp_report.write_text(json.dumps({
            src.name: [ln.strip() for ln in err.splitlines()
                       if "ptxas info" in ln or "spill" in ln]
            for src, err in zip(cu, errs)}, indent=1))
        os.replace(tmp_report, report)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        tmp_report.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    print(f"[aqp_tpu_torch] built {out.name} from {len(cu)} sources in "
          f"{secs:.2f} s", file=sys.stderr, flush=True)
    return out, secs


def ptxas_report(name: str, build_dir: Optional[Path] = None) -> list[str]:
    """What `-Xptxas -v` said of each kernel of csrc/<name> when the
    library in build_dir (default BUILD_DIR) was built: its registers,
    shared memory and spill stores and loads."""
    return json.loads(report_path(build_dir).read_text())[name]


def spill_bytes(report: list[str]) -> int:
    """Bytes of spill stores and loads over a ptxas_report."""
    total = 0
    for ln in report:
        words = ln.replace(",", " ").split()
        for i, w in enumerate(words[:-1]):
            if w == "spill" and words[i + 1] in ("stores", "loads"):
                total += int(words[i - 2])
    return total


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


def on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor
    (the plain version runs); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def need(x: Optional[torch.Tensor], name: str, shape, device) -> None:
    """Raise unless x (when given) is a contiguous int32 tensor of `shape`
    on `device`."""
    if x is None:
        return
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(x: Optional[torch.Tensor]):
    """The device pointer of x as a Python int, None for no tensor."""
    return None if x is None else x.data_ptr()


def stream(device: torch.device) -> int:
    """The current CUDA stream of `device`, as the launchers take it."""
    return torch.cuda.current_stream(device).cuda_stream

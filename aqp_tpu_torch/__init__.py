"""aqp_tpu_torch: the PyTorch/CUDA port of aqp_tpu for one NVIDIA H100.

The JAX package `aqp_tpu` beside it is the reference this package is held
against.  This package imports torch and never jax, and nothing of
`aqp_tpu`.  Every kernel that `aqp_tpu` wrote in Pallas is a hand-written
CUDA kernel here (`csrc/`, built by `ops/kernels/build.py`), with a plain
PyTorch version beside it: a tensor on the CPU takes the plain version, a
tensor on a CUDA device takes the kernel.

Every entry point (the generators, `Relation.from_numpy`, `run_join`,
`finalize_join`, the `engine` functions) takes a `device` that defaults to
"cuda" and raises when no CUDA device is present; pass device="cpu" to run
on the CPU.  An entry point given tensors on another device raises too.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The first CUDA device; raises when there is none."""
    return resolve_device("cuda")


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "aqp_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU")
    return dev


def check_device(device, *tensors: torch.Tensor) -> torch.device:
    """Resolve `device` and require every tensor to lie on it."""
    dev = resolve_device(device)
    for t in tensors:
        if t.device.type != dev.type or (
                dev.index is not None and t.device.index != dev.index):
            raise ValueError(f"a tensor is on {t.device}, not on {dev}; "
                             "move it or pass the matching device=")
    return dev

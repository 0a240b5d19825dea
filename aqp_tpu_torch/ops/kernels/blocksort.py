"""Block sort (counterpart of aqp_tpu/ops/pallas/blocksort.py).

`sort_blocks(key, payload, sub)` sorts each block of sub*128 int32 (key,
payload) pairs independently, ascending by key.  Equal keys are ordered by
payload as unsigned 32-bit values.  The reference's bitonic network never
exchanges equal keys, so its payload order among them is the network's
own; the port defines it, and its kernel and plain version then agree bit
for bit.  Keys are equal by position in both packages, and each block holds
the same (key, payload) pairs.

`sort_blocks_plain` is one torch.sort along the rows of the (blocks,
block) int64 composite key << 32 | uint32(payload); `sort_blocks` sends a
CPU tensor to it and a CUDA tensor to the hand-written kernel in
csrc/blocksort.cu, with no fallback from one to the other.  `LAUNCHES`
counts the kernel launches.

The reference sorts a column-major (sub, 128) tile; `to_colmajor` and
`from_colmajor` are its layout helpers, kept as plain functions.  The port
sorts blocks in flat order and needs neither.
"""

from __future__ import annotations

import torch

from aqp_tpu_torch.ops.kernels import build
from aqp_tpu_torch.ops.kernels.build import need, on_cuda, ptr, stream
from aqp_tpu_torch.ops.kernels.rho3 import KEY_PAD_INT, LANES

__all__ = ["LANES", "SUB", "BLOCK", "KEY_PAD_INT", "KEY_PAD", "LAUNCHES",
           "SUBS", "sort_blocks", "sort_blocks_plain", "to_colmajor",
           "from_colmajor"]

SUB = 512                  # default rows of 128 per block (64 Ki pairs)
BLOCK = SUB * LANES
KEY_PAD = KEY_PAD_INT      # pads sort last; never a data key
# The block heights the kernel takes (the reference's callers use 128 to
# 1024); a block of 128 rows is one shared-memory tile of the kernel.
SUBS = (128, 256, 512, 1024)
TILE = 128 * LANES

LAUNCHES = {"sort_blocks": 0}

_U32 = 0xFFFFFFFF


def to_colmajor(x: torch.Tensor, nb: int, sub: int) -> torch.Tensor:
    """(nb*sub*128,) logical order -> (nb*sub, 128) column-major blocks."""
    return x.reshape(nb, LANES, sub).transpose(1, 2).reshape(nb * sub, LANES)


def from_colmajor(x: torch.Tensor, nb: int, sub: int) -> torch.Tensor:
    return x.reshape(nb, sub, LANES).transpose(1, 2).reshape(nb * sub * LANES)


def check_blocks(n: int, sub: int) -> int:
    """The number of blocks of n elements; raises unless sub is one of
    SUBS and n a whole number of blocks."""
    if sub not in SUBS:
        raise ValueError(f"sub={sub}; the block sort takes sub in {SUBS}")
    block = sub * LANES
    if n % block:
        raise ValueError(f"{n} elements are not a whole number of "
                         f"{block}-element blocks (pad with KEY_PAD_INT)")
    return n // block


def composite(key: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """key << 32 | uint32(payload) as int64: ordered by key, then by the
    payload as unsigned."""
    return (key.long() << 32) | (payload.long() & _U32)


def split(c: torch.Tensor):
    """The (key, payload) int32 pair of each composite."""
    return (c >> 32).to(torch.int32), (c & _U32).to(torch.int32)


def sort_blocks_plain(key, payload, sub: int = SUB):
    """Each sub*128-element block of (key, payload) sorted, as two int32
    (n,) tensors."""
    nb = check_blocks(key.numel(), sub)
    c = composite(key, payload).view(nb, sub * LANES)
    return split(torch.sort(c, dim=1).values.reshape(-1))


def launch_sort(name: str, key, payload, sub: int, hist=None):
    """Check the inputs, allocate the outputs and scratch, and call the
    launcher `name`: sort_blocks, or sort_hist with hist = (F, scale,
    starts).  Returns (ok, op), int32 (n,)."""
    dev = key.device
    n = key.numel()
    check_blocks(n, sub)
    need(key, "key", (n,), dev)
    need(payload, "payload", (n,), dev)
    ok = torch.empty((n,), dtype=torch.int32, device=dev)
    op = torch.empty((n,), dtype=torch.int32, device=dev)
    # blocks above one tile are merged through a 64-bit work array
    work = (torch.empty((n,), dtype=torch.int64, device=dev)
            if sub * LANES > TILE else None)
    lib = build.load()
    if hist is None:
        err = lib.sort_blocks(ptr(key), ptr(payload), n, sub, ptr(work),
                              ptr(ok), ptr(op), stream(dev))
    else:
        F, scale, starts = hist
        err = lib.sort_hist(ptr(key), ptr(payload), n, sub, F, scale,
                            ptr(work), ptr(ok), ptr(op), ptr(starts),
                            stream(dev))
    build.check(lib, err, name)
    return ok, op


def sort_blocks(key, payload, sub: int = SUB):
    """Sort each sub*128-element block of (key, payload) independently.
    Input length must be a whole number of blocks (pad keys with
    KEY_PAD_INT).  Returns (keys, payloads), int32 (n,)."""
    if not on_cuda(key):
        return sort_blocks_plain(key, payload, sub)
    ok, op = launch_sort("sort_blocks", key, payload, sub)
    LAUNCHES["sort_blocks"] += 1
    return ok, op

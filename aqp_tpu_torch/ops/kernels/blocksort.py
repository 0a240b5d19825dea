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
CPU tensor to it and a CUDA tensor to the hand-written kernels in
csrc/blocksort.cu (a radix sort of each 16 Ki-pair tile, then
`merge_levels(sub)` levels of pairwise merges), with no fallback from one
to the other.  `LAUNCHES` counts the calls that launch them;
`kernel_launches()` counts the kernels their launchers have launched, by
name.

`tile_plan(key, payload)` counts how the tile sort plans each tile of the
same input (which digits it sorts, and in what order), as the kernel
records it while it sorts; `tile_plan_plain` derives the same counts.

The reference sorts a column-major (sub, 128) tile; `to_colmajor` and
`from_colmajor` are its layout helpers, kept as plain functions.  The port
sorts blocks in flat order and needs neither.
"""

from __future__ import annotations

import ctypes

import torch

from aqp_tpu_torch.ops.kernels import build
from aqp_tpu_torch.ops.kernels.build import need, on_cuda, ptr, stream
from aqp_tpu_torch.ops.kernels.rho3 import KEY_PAD_INT, LANES

__all__ = ["LANES", "SUB", "BLOCK", "KEY_PAD_INT", "KEY_PAD", "LAUNCHES",
           "KERNELS", "PLAN_COUNTS", "SUBS", "TILE", "kernel_launches",
           "merge_levels", "sort_blocks",
           "sort_blocks_plain", "tile_plan", "tile_plan_plain",
           "to_colmajor", "from_colmajor"]

SUB = 512                  # default rows of 128 per block (64 Ki pairs)
BLOCK = SUB * LANES
KEY_PAD = KEY_PAD_INT      # pads sort last; never a data key
# The block heights the kernel takes (the reference's callers use 128 to
# 1024); a block of 128 rows is one tile of the kernel's radix sort.
SUBS = (128, 256, 512, 1024)
TILE = 128 * LANES
TILE_WARPS = 16            # a tile's warps; each holds 1,024 positions
WARP = 32

LAUNCHES = {"sort_blocks": 0, "tile_plan": 0}
# csrc/blocksort.cu's kernels, in the order sort_kernel_launches counts them
KERNELS = ("tile_sort_kernel", "merge_kernel", "row_starts_kernel")

# tile_plan's counts (csrc/blocksort.cu's Plan): tiles, LSD passes, then
# tiles by plan: "direct" sorts its varying digits (keys or payloads
# constant, or payloads ascending in position order); a tile whose keys
# and payloads both vary sorts its key digits first and is "key-first
# kept" when that leaves it in order, else "key-first failed" and sorts
# every varying digit again; "repeated keys" (most of the first 32 keys of
# a quarter of its warps equal their first) sorts every digit at once.
PLAN_COUNTS = ("tiles", "passes", "direct", "key-first kept",
               "key-first failed", "repeated keys")

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


def merge_levels(sub: int) -> int:
    """Levels of pairwise merges after the tile sort: log2(block / TILE).
    Each launch of the kernels (the tile sort, then one per level) moves
    every pair through device memory once."""
    return (sub * LANES // TILE).bit_length() - 1


def kernel_launches() -> dict:
    """The kernels of csrc/blocksort.cu launched since the library was
    loaded, by KERNELS name: each launcher counts a launch that returned
    without error."""
    out = (ctypes.c_longlong * len(KERNELS))()
    build.load().sort_kernel_launches(ctypes.addressof(out))
    return dict(zip(KERNELS, out))


def scratch(n: int, sub: int, device):
    """The kernels' 64-bit work array: none when a block is one tile; n
    values for one merge level (the tile sort writes it, the level reads
    it); 2n for more, whose levels alternate between the two halves."""
    levels = merge_levels(sub)
    if levels == 0:
        return None
    return torch.empty((n * min(levels, 2),), dtype=torch.int64,
                       device=device)


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
    work = scratch(n, sub, dev)
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


def _popcount8(x: torch.Tensor) -> torch.Tensor:
    return sum((x >> j) & 1 for j in range(8))


def tile_plan_plain(key, payload) -> dict:
    """tile_plan's counts over the TILE-pair tiles of (key, payload),
    derived from the values: the digits that vary over a tile, whether its
    payloads ascend, its warps' first 32 keys, and whether a stable sort by
    key alone leaves its payloads ascending among equal keys."""
    nt = check_blocks(key.numel(), 128)
    c = composite(key, payload).view(nt, TILE)
    digits = torch.zeros(nt, dtype=torch.int64, device=key.device)
    for j in range(8):
        d = (c >> (8 * j)) & 0xFF
        digits |= (d.amax(1) != d.amin(1)).long() << j
    pay = (payload.long() & _U32).view(nt, TILE)
    digits = torch.where((pay[:, 1:] >= pay[:, :-1]).all(1), digits & 0xF0,
                         digits)
    first = key.view(nt, TILE_WARPS, TILE // TILE_WARPS)[:, :, :WARP]
    marks = (first == first[:, :, :1]).sum(2) > WARP // 2
    repeated = 4 * marks.sum(1) >= TILE_WARPS
    both = ((digits & 0x0F) != 0) & ((digits & 0xF0) != 0)
    keys, order = torch.sort(key.view(nt, TILE), dim=1, stable=True)
    pay = pay.gather(1, order)
    kept = ~((keys[:, 1:] == keys[:, :-1])
             & (pay[:, 1:] < pay[:, :-1])).any(1)
    key_first = both & ~repeated
    passes = torch.where(
        key_first,
        _popcount8(digits & 0xF0) + torch.where(kept, 0, _popcount8(digits)),
        _popcount8(digits))
    counts = (nt, passes.sum(), ~both, key_first & kept, key_first & ~kept,
              both & repeated)
    return {name: int(x.sum()) if torch.is_tensor(x) else x
            for name, x in zip(PLAN_COUNTS, counts)}


def tile_plan(key, payload) -> dict:
    """How the tile sort plans each TILE-pair tile of (key, payload), n a
    whole number of tiles: PLAN_COUNTS by name.  The kernel counts them as
    it sorts the tiles (each tile is sorted the same way at every sub);
    a CPU tensor takes tile_plan_plain."""
    if not on_cuda(key):
        return tile_plan_plain(key, payload)
    dev = key.device
    n = key.numel()
    check_blocks(n, 128)
    need(key, "key", (n,), dev)
    need(payload, "payload", (n,), dev)
    ok = torch.empty((n,), dtype=torch.int32, device=dev)
    op = torch.empty((n,), dtype=torch.int32, device=dev)
    plan = torch.zeros((len(PLAN_COUNTS),), dtype=torch.int32, device=dev)
    lib = build.load()
    err = lib.sort_tile_plan(ptr(key), ptr(payload), n, ptr(ok), ptr(op),
                             ptr(plan), stream(dev))
    build.check(lib, err, "sort_tile_plan")
    LAUNCHES["tile_plan"] += 1
    return dict(zip(PLAN_COUNTS, plan.tolist()))


def sort_blocks(key, payload, sub: int = SUB):
    """Sort each sub*128-element block of (key, payload) independently.
    Input length must be a whole number of blocks (pad keys with
    KEY_PAD_INT).  Returns (keys, payloads), int32 (n,)."""
    if not on_cuda(key):
        return sort_blocks_plain(key, payload, sub)
    ok, op = launch_sort("sort_blocks", key, payload, sub)
    LAUNCHES["sort_blocks"] += 1
    return ok, op

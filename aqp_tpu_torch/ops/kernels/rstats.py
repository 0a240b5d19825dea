"""The skew tier's R-side candidate statistics (counterpart of
r_cand_stats / r_cand_stats_pallas in aqp_tpu/joins/skewtier.py).

Per candidate slot: how many R rows carry its key, and the sum of their
payloads mod 2^32.  A negative slot (the -1 of an empty candidate) counts
nothing; repeated slots each get the full count.  Exact for any R, where
the reference's MXU form is exact only for unique R keys.

`r_cand_stats_kernel` sends a CPU tensor to `r_cand_stats_plain` and a CUDA
tensor to the hand-written kernel in csrc/rstats.cu (one pass over R's
keys, each looked up in a hash table of the candidates in shared memory,
a payload read only where a key hits); there is no fallback from one to
the other.  A call on the card is one (2, h) int64 output, which the
launcher zeroes (one memset), and one launch; the two results are views of
it.  `LAUNCHES` counts the kernel launches.

`Candidates` is the candidate lookup the plain version and the skew tier's
split pass share.
"""

from __future__ import annotations

import functools

import torch

from aqp_tpu_torch.ops.kernels import build
from aqp_tpu_torch.ops.kernels.build import need, on_cuda, ptr, stream

LAUNCHES = {"RSTATS": 0}

_U32 = 0xFFFFFFFF


class Candidates:
    """hk sorted once, for lookups of many keys: `first[i]` is the sorted
    index of the first slot equal to sorted slot i, so duplicate candidates
    act as one group."""

    def __init__(self, hk: torch.Tensor):
        self.hs, self.order = torch.sort(hk)
        self.first = torch.searchsorted(self.hs, self.hs)

    def lookup(self, x: torch.Tensor):
        """(group, eq): for each x, the first sorted slot not below it and
        whether that slot equals x."""
        hs = self.hs.to(x.dtype)
        g = torch.searchsorted(hs, x).clamp(max=hs.numel() - 1)
        return g, hs[g] == x

    def group_sum(self, v: torch.Tensor) -> torch.Tensor:
        """Per sorted slot, the sum of v (given per sorted slot) over its
        group, at the group's first slot."""
        return torch.zeros_like(v).index_add_(0, self.first, v)

    def to_slots(self, per_group: torch.Tensor) -> torch.Tensor:
        """Per-group values back to hk's slot order."""
        out = torch.empty_like(per_group)
        out[self.order] = per_group[self.first]
        return out


def r_cand_stats_plain(rk, rp, hk, with_pay: bool = True):
    """Per candidate slot, (count, payload sum mod 2^32) over R as int64
    (h,); payload sums are 0 when with_pay=False."""
    cand = Candidates(hk)
    g, eq = cand.lookup(rk)
    eq &= rk >= 0
    h = hk.numel()
    gi = g[eq]
    cnt = torch.zeros(h, dtype=torch.int64, device=rk.device)
    cnt.index_add_(0, gi, torch.ones_like(gi))
    pay = torch.zeros_like(cnt)
    if with_pay:
        pay.index_add_(0, gi, rp[eq].long() & _U32)
    return cand.to_slots(cnt), cand.to_slots(pay) & _U32


@functools.cache
def max_candidates() -> int:
    """Most candidate slots RSTATS takes (the library's RSTATS_MAX_H),
    asked once a process."""
    return build.load().rstats_max_h()


def r_cand_stats_kernel(rk, rp, hk, with_pay: bool = True):
    """RSTATS (see r_cand_stats_plain): int32 rk (n,), rp (n,) when
    with_pay, hk (h,)."""
    if not on_cuda(rk):
        return r_cand_stats_plain(rk, rp, hk, with_pay)
    dev = rk.device
    n = rk.numel()
    need(rk, "rk", (n,), dev)
    if with_pay:
        if rp is None:
            raise ValueError("RSTATS needs the payloads when with_pay=True")
        need(rp, "rp", (n,), dev)
    h = hk.numel()
    need(hk, "hk", (h,), dev)
    lib = build.load()
    if not 1 <= h <= max_candidates():
        raise ValueError(f"{h} candidates; RSTATS takes 1 to "
                         f"{max_candidates()}")
    # row 0 the counts, row 1 the payload sums; the launcher zeroes it and
    # the kernel adds into the low word of each sum, which wraps mod 2^32
    # and leaves the high word 0
    out = torch.empty((2, h), dtype=torch.int64, device=dev)
    err = lib.rstats(ptr(rk), ptr(rp) if with_pay else None, n, ptr(hk), h,
                     ptr(out), stream(dev))
    build.check(lib, err, "RSTATS")
    LAUNCHES["RSTATS"] += 1
    return out.unbind()

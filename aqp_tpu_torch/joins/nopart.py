"""No-partition hash joins: the PHT family, NPO_st / NPO_no and NPBC_st
(counterpart of aqp_tpu/joins/nopart.py).

PHT, PHT_no, PHT_un, PHT_o, NPO_st and NPO_no serve through the shared
hash-ordered table of ops/kernels/nphj.py (build once, probe as a stream),
each at its variant's geometry, on RHO's ladder (joins/radix.py): for
counts the skew tiers when the sampled plan says so (their residual is the
variant's own build/probe pipeline at kd = 128), the pipeline under each
salt, then the exact core; for materialize the pipeline under each salt,
then the exact core.  A caller's input-pad key (2^30 - 2 or 2^30 - 1) goes
to the exact core at once.  JoinConfig.defer returns the first tier's
result unchecked, with its overflow counter.

The reference takes the pipeline only on a TPU.  The port takes it on every
device whenever use_pallas is set (kernels on a CUDA device, plain versions
on the CPU), as its RHO does.  use_pallas=False or profile_phases=True
takes the staged open-addressing engine below, as the reference does off
the TPU:

  build_table   parallel linear probing by rounds of scatter-min: a slot's
                winner is the smallest key contending for it, losers move
                on one slot.  Slots fill monotonically, so a key stored at
                displacement d has no empty slot before it and probes stop
                at the first empty one.
  probe_table   gathers a window of consecutive slots per key, then loops
                for the rare key still unresolved.

Both need unique R keys (every reference PHT workload has a PK build side);
a duplicate R key is counted once per S row.  JoinConfig.load_factor sizes
the open-addressing table (clamped to 0.5) and probe_window sets its probe
window; PHT_no / NPO_no halve the load factor, PHT_o doubles it.

NPBC_st is bucket chaining (no kernel, plain PyTorch on every device): R
grouped by hash bucket, a chain being the bucket's contiguous span.  By
default one bucket-major sort of R and S and the duplicate-exact run-count
scan (every equal R key in a chain is counted); profile_phases keeps the
staged build / chain-walk probe; materialize goes to the exact core.

Every name takes int32 and int64 keys, as RHO does.  An int64 key reaches
no kernel: the PHT family and NPO_st / NPO_no take the staged
open-addressing engine, NPBC_st its own forms, whose bucket-major order
sorts an int64 key raw.  A real key equal to the EMPTY marker (the dtype's
largest value) is held beside the table, not in it, so it joins as any key
does.  Deliberate differences: NPBC packs an int32 key in int64 where the
reference's int32 `key << 1` wraps for |key| >= 2^30; the EMPTY-valued key
is exact in both dtypes.
"""

from __future__ import annotations

import functools
import math
import time

import torch

from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.joins.api import register
from aqp_tpu_torch.joins.common import result_capacity, to_join_result
# a module import: joins.api imports this module while radix may still be
# loading
from aqp_tpu_torch.joins import radix
from aqp_tpu_torch.joins.skewtier import skew_plan
from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.ops.hashing import fib_hash32
from aqp_tpu_torch.ops.kernels.nphj import (VARIANT_PARAMS,
                                            VARIANT_PIPELINES_SKEW,
                                            nphj_join_count,
                                            nphj_join_materialize)
from aqp_tpu_torch.ops.kernels.rho3 import RETRY_SALTS
from aqp_tpu_torch.relation import Relation
from aqp_tpu_torch.utils.timing import PhaseTimer

_MAX_BUILD_ROUNDS = 64
_U32 = 0xFFFFFFFF


def _empty(dtype: torch.dtype) -> int:
    """The EMPTY slot marker: the key type's largest value."""
    return torch.iinfo(dtype).max


def build_table(r_key, r_payload, table_bits: int):
    """Open-addressing build by scatter-min rounds.

    Returns (table_key[T + slack + 1], table_payload[T + slack + 1],
    max_displacement) with T = 2^table_bits.  The slack region absorbs
    linear probes past the table's end (no wraparound).  The last slot is
    no probe's: its payload is that of R's row keyed EMPTY, which has no
    slot of its own, and its key is EMPTY when R holds such a row, else
    EMPTY - 1 (read by `probe_table`).  The round bound ends the loop for
    any key set; rows left over then are dropped (impossible at load <=
    0.5 in practice)."""
    T = 1 << table_bits
    slack = _MAX_BUILD_ROUNDS
    dev = r_key.device
    empty = _empty(r_key.dtype)
    # one slot past the table takes the scatters of settled rows
    tkey = torch.full((T + slack + 1,), empty, dtype=r_key.dtype,
                      device=dev)
    slot0 = fib_hash32(r_key, table_bits).long()
    slot = slot0
    keyed_empty = r_key == empty
    active = ~keyed_empty
    rounds = 0
    while rounds < _MAX_BUILD_ROUNDS and bool(active.any()):
        target = torch.where(active, slot, T + slack)
        tkey.scatter_reduce_(0, target, r_key, reduce="amin")
        settled = keyed_empty | (tkey[slot] == r_key)
        # a smaller key owns the slot: move on (a settled row evicted by a
        # smaller key becomes active again)
        slot = torch.where(settled, slot, slot + 1)
        active = ~settled
        rounds += 1
    # unique keys -> unique final slots: the payload scatter has no
    # conflict; the EMPTY-keyed row goes to the last slot
    slot = torch.where(keyed_empty, T + slack, slot)
    tpay = torch.zeros((T + slack + 1,), dtype=r_payload.dtype, device=dev)
    tpay[slot] = r_payload
    tkey[T + slack] = torch.where(keyed_empty.any(), empty, empty - 1)
    max_disp = ((slot - slot0).max() if slot.numel()
                else torch.zeros((), dtype=torch.int64, device=dev))
    return tkey, tpay, max_disp


def probe_table(tkey, tpay, s_key, table_bits: int, window: int):
    """Windowed probe: gather `window` consecutive slots per key, then loop
    over the keys still unresolved (neither hit nor an empty slot seen).
    An S key equal to EMPTY reads the build's last slot instead.
    Returns (found, r_payload)."""
    slot0 = fib_hash32(s_key, table_bits).long()
    last = tkey.numel() - 2
    empty = _empty(tkey.dtype)
    keyed_empty = s_key == empty
    found = keyed_empty & (tkey[-1] == empty)
    open_ = keyed_empty.clone()   # saw EMPTY (or is it): no more probes
    rpay = torch.where(found, tpay[-1], 0).to(tpay.dtype)

    def step(w):
        nonlocal found, open_, rpay
        at = (slot0 + w).clamp(max=last)
        k = tkey[at]
        hit = ~found & ~open_ & (k == s_key)
        rpay = torch.where(hit, tpay[at], rpay)
        found = found | hit
        open_ = open_ | (~found & (k == empty))

    for w in range(window):
        step(w)
    w = window
    while w <= last and bool((~(found | open_)).any()):
        step(w)
        w += 1
    return found, rpay


def _probe_and_finish(tkey, tpay, s_key, s_payload, table_bits: int,
                      window: int, capacity: int):
    """Probe, then count and checksum (capacity 0) or materialize into
    mergejoin.compact_matches' layout."""
    found, rpay = probe_table(tkey, tpay, s_key, table_bits, window)
    if capacity == 0:
        ck = torch.where(found, ((rpay.long() & _U32)
                                 + (s_payload.long() & _U32)) & _U32, 0)
        return mergejoin.JoinCounts(found.sum(), ck.sum() & _U32)
    return mergejoin.compact_matches(found, s_key, rpay, s_payload,
                                     capacity)


def table_bits_for(num_r: int, load_factor: float) -> int:
    """log2 of the table size: open addressing with a bounded round budget
    needs load <= 0.5, so higher requested loads are clamped (the probe
    window plays the chain's role)."""
    load_factor = min(load_factor, 0.5)
    return max(4, math.ceil(math.log2(max(2, num_r / load_factor))))


def _pipeline(relR, relS, cfg, pt, variant):
    """The nphj pipeline on RHO's ladder; None when every tier overflowed
    (or a key is an input pad)."""
    if radix.holds_input_pads(relR.key, relS.key):
        return None
    prm = VARIANT_PARAMS[variant]
    if cfg.materialize:
        mat = functools.partial(nphj_join_materialize, prm=prm)
        return radix.walk_ladder(relR, relS, cfg, pt,
                                 [(mat, s, False) for s in RETRY_SALTS])
    hinted, cap_rows = skew_plan(relS.key)
    count = functools.partial(nphj_join_count, prm=prm)
    return radix.walk_ladder(relR, relS, cfg, pt, radix.count_tiers(
        relR, cfg, hinted, cap_rows, count=count,
        pipeline=VARIANT_PIPELINES_SKEW[variant]))


def _nopart(relR: Relation, relS: Relation, cfg: JoinConfig, window: int,
            variant: str = "PHT"):
    radix.require_key_dtype(variant, relR, relS)
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    if (cfg.use_pallas and not cfg.profile_phases
            and not radix.is_key64(relR, relS)):
        res = _pipeline(relR, relS, cfg, pt, variant)
        if res is None:
            res = radix.exact_core(relR, relS, cfg, pt)
    else:
        tb = table_bits_for(relR.num_tuples, cfg.load_factor)
        tkey, tpay, _ = pt.time_fn("build", build_table, relR.key,
                                   relR.payload, tb)
        cap = result_capacity(relS, cfg) if cfg.materialize else 0
        res = to_join_result(pt.time_fn(
            "probe", _probe_and_finish, tkey, tpay, relS.key, relS.payload,
            tb, window, cap))
    pt.t.phases["total"] = time.perf_counter() - t0
    return res, pt.t


@register("PHT")
def PHT(relR, relS, cfg):
    return _nopart(relR, relS, cfg, window=cfg.probe_window, variant="PHT")


@register("PHT_no")
def PHT_no(relR, relS, cfg):
    """No-overflow variant: a larger table, lower per-bucket load (f1 = 48
    on the pipeline)."""
    return _nopart(relR, relS, cfg.replace(load_factor=cfg.load_factor / 2),
                   window=4, variant="PHT_no")


@register("PHT_un")
def PHT_un(relR, relS, cfg):
    """'Unrolled' variant: a wider probe window in one vector pass."""
    return _nopart(relR, relS, cfg, window=max(10, cfg.probe_window),
                   variant="PHT_un")


@register("PHT_o")
def PHT_o(relR, relS, cfg):
    """Overflow-chain variant: a smaller table (load 1.0), longer probes."""
    return _nopart(relR, relS,
                   cfg.replace(load_factor=min(1.0, cfg.load_factor * 2)),
                   window=max(16, cfg.probe_window), variant="PHT_o")


@register("NPO_st")
def NPO_st(relR, relS, cfg):
    return _nopart(relR, relS, cfg, window=cfg.probe_window,
                   variant="NPO_st")


@register("NPO_no")
def NPO_no(relR, relS, cfg):
    return _nopart(relR, relS, cfg.replace(load_factor=cfg.load_factor / 2),
                   window=4, variant="NPO_no")


# ---------------------------------------------------------------------------
# NPBC_st: bucket chaining


def npbc_build(r_key, r_payload, nb_bits: int):
    """Bucket-chaining build: R grouped by hash bucket (one stable sort),
    the bucket heads kept as span offsets; a chain IS its bucket's
    contiguous span, in R's order.  Returns (grouped keys, grouped
    payloads, bucket offsets (2^nb_bits + 1,), longest chain)."""
    nb = 1 << nb_bits
    b = fib_hash32(r_key, nb_bits)
    b_s, order = torch.sort(b, stable=True)
    bounds = torch.searchsorted(
        b_s, torch.arange(nb + 1, dtype=b_s.dtype, device=b_s.device))
    longest = (bounds[1:] - bounds[:-1]).max()
    return r_key[order], r_payload[order], bounds, longest


def npbc_probe_count(rk_s, rp_s, bounds, s_key, s_payload, nb_bits: int,
                     chain_cap: int):
    """Chain-walk probe: each S row walks its bucket's span and counts
    EVERY equal key, so duplicate R keys count in full.  chain_cap must be
    at least the longest chain.  Returns (matches, checksum) as 0-dim int64
    tensors."""
    dev = s_key.device
    matches = torch.zeros((), dtype=torch.int64, device=dev)
    ck = torch.zeros((), dtype=torch.int64, device=dev)
    if rk_s.numel() == 0:
        return matches, ck
    sb = fib_hash32(s_key, nb_bits).long()
    start, end = bounds[sb], bounds[sb + 1]
    sp = s_payload.long() & _U32
    last = rk_s.numel() - 1
    for j in range(chain_cap):
        pos = start + j
        at = pos.clamp(max=last)
        hit = (pos < end) & (rk_s[at] == s_key)
        matches = matches + hit.sum()
        ck = ck + torch.where(hit, ((rp_s[at].long() & _U32) + sp) & _U32,
                              0).sum()
    return matches, ck & _U32


def _npbc_fused(rk, rp, sk, sp, nb_bits: int, checksum: bool):
    """Fused bucket-chaining count join: the union of R and S ordered
    bucket-major (bucket, then key, R before S), and the duplicate-exact
    run-count scan over it: every equal-key R row of a chain counts."""
    b = fib_hash32(torch.cat([rk, sk]), nb_bits).long()
    key, is_r, order = mergejoin.sorted_union(rk, sk, major=b)
    if checksum:
        return mergejoin.count_general_runs(key, is_r,
                                            torch.cat([rp, sp])[order])
    out = mergejoin.count_general_runs(key, is_r, torch.zeros_like(key))
    return mergejoin.JoinCounts(out.matches, torch.zeros_like(out.checksum))


@register("NPBC_st")
def NPBC_st(relR, relS, cfg):
    """Bucket-chaining join: grouped-span chains and chain-walk probes,
    2^ceil(log2 |R|) buckets as the reference sizes them (at most 2^24 in
    the fused form).  Counts every duplicate in a chain."""
    radix.require_key_dtype("NPBC_st", relR, relS)
    pt = PhaseTimer(relR.device)
    t0 = time.perf_counter()
    nb_bits = max(4, math.ceil(math.log2(max(2, relR.num_tuples))))
    if not cfg.profile_phases and not cfg.materialize:
        out = pt.time_fn("join", _npbc_fused, relR.key, relR.payload,
                         relS.key, relS.payload, min(nb_bits, 24),
                         cfg.checksum)
    elif cfg.materialize:
        # chains are grouped spans; output rows come from the exact core,
        # as in the reference
        pt.time_fn("build", npbc_build, relR.key, relR.payload, nb_bits)
        out = pt.time_fn("probe", mergejoin.merge_join_materialize,
                         relR.key, relR.payload, relS.key, relS.payload,
                         result_capacity(relS, cfg))
    else:
        rk_s, rp_s, bounds, longest = pt.time_fn(
            "build", npbc_build, relR.key, relR.payload, nb_bits)
        # the chain budget: the longest chain, rounded up to a power of two
        cap = 1 << max(1, math.ceil(math.log2(max(1, int(longest)))))
        out = mergejoin.JoinCounts(*pt.time_fn(
            "probe", npbc_probe_count, rk_s, rp_s, bounds, relS.key,
            relS.payload, nb_bits, cap))
    pt.t.phases["total"] = time.perf_counter() - t0
    return to_join_result(out), pt.t

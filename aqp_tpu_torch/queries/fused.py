"""Fused TPC-H plans with bounded buffers (counterpart of
aqp_tpu/queries/fused.py).

Each query runs filter -> join -> transform -> join (-> residual) with no
host round trip between its steps, and returns (matches, ok) as 0-dim
tensors on the tables' device.  Selection is pushed down under fixed
buffer sizes: each buffer is a fraction of its table, about 1.5 times the
predicate's TPC-H selectivity, and every bound is checked.  ok is False
when a bound was exceeded (data that is not TPC-H-shaped) or a join key
lies outside the pipeline's domain; the caller then runs the staged plan
(queries/tpch.py).  A plan never returns ok with a wrong count.

`_kernel_route` decides each step's route, from the tensors' device and
the reference's size thresholds:

* kernel route (a CUDA tensor): compaction through the window compactor
  and the segment scatters (`compact_kp_fast` / `compact_k_fast`: B5 +
  B6a / B6b), with the predicate's pad pushed into the key; count joins
  through the keys-only rho3 pipeline (K1, K2, K3), which drops the input
  pads in its own packing; materializing joins of 2^23 input rows or more
  through the rho3 materializer (K1, K2, K3M), whose region-chunked
  output carries holes keyed -3;
* plain route: the stable compaction of queries/filters.py and the exact
  sort cores of ops/mergejoin.py.

On the CPU every step takes the plain route; tests that replace
`_kernel_route` send a CPU tensor down the kernel route, where each kernel
wrapper runs its plain version.
"""

from __future__ import annotations

import torch

from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.ops.kernels.lanecompact import (compact_k_fast,
                                                   compact_kp_fast)
from aqp_tpu_torch.ops.kernels.rho3 import (LANES, MAX_KEY, PAD_R_INPUT,
                                            PAD_S_INPUT, rho_join_count_v3,
                                            rho_join_materialize_v3)
from aqp_tpu_torch.queries import filters as F
from aqp_tpu_torch.queries import tables as T

# The reference's thresholds: the lane compactor from 32,768 rows
# (fused.py:72, 87), the materializing pipeline from 2^23 input rows
# (fused.py:104).  The count joins take the pipeline at any size.
COMPACT_MIN_ROWS = 32768
MAT_JOIN_MIN_ROWS = 1 << 23


def _kernel_route(t: torch.Tensor, rows: int, min_rows: int) -> bool:
    """True when a step over `rows` rows of `t` runs on the hand-written
    kernels: `t` lies on a CUDA device and rows >= min_rows."""
    return t.device.type == "cuda" and rows >= min_rows


def _cap(n: int, num: int, den: int) -> int:
    """Bounded-buffer capacity in elements: ceil(n*num/den) rounded up to
    whole 256-row blocks of 128 (the compactor's rows), at most n."""
    c = -(-n * num // den)
    return min(n, -(-c // 32768) * 32768) if n >= 32768 else n


def _in_domain(*keys_and_limits) -> torch.Tensor:
    """0-dim bool: every key lies in [0, limit), for (key column, limit)
    pairs.  A key at or past MAX_KEY would be taken for a pad (and an
    R key equal to the S pad would meet the S pads on the plain route),
    so such a table makes ok False rather than the count wrong.  One
    read of each column: its least and greatest key."""
    ok = torch.ones((), dtype=torch.bool, device=keys_and_limits[0][0].device)
    for key, limit in keys_and_limits:
        if key.numel():
            lo, hi = torch.aminmax(key)
            ok = ok & (lo >= 0) & (hi < limit)
    return ok


def _compact(mask, key, payload, cap_elems: int, pad):
    """Bounded compaction of (key, payload) where `mask` into cap_elems
    elements.  Returns (key, payload, ok); ok is False when more rows pass
    than the buffer (or a window's share of it) holds."""
    n = key.shape[0]
    if (_kernel_route(key, n, COMPACT_MIN_ROWS)
            and cap_elems % LANES == 0):
        mk = torch.where(mask, key, pad)
        mp = torch.where(mask, payload, 0)
        k, p, ovf = compact_kp_fast(mk, mp, cap_elems // LANES, pad_key=pad,
                                    keep_frac=min(1.0, cap_elems / n))
        return k, p, ovf == 0
    k, p, count = F._compact_kp(mask, key, payload, pad)
    return k[:cap_elems], p[:cap_elems], count <= cap_elems


def _compact_keys(mask, key, cap_elems: int, pad):
    """Keys-only bounded compaction for a count join's probe side (the
    keys-only pipeline never reads payloads).  Returns (key, ok)."""
    n = key.shape[0]
    if (_kernel_route(key, n, COMPACT_MIN_ROWS)
            and cap_elems % LANES == 0):
        k, ovf = compact_k_fast(torch.where(mask, key, pad),
                                cap_elems // LANES, pad_key=pad,
                                keep_frac=min(1.0, cap_elems / n))
        return k, ovf == 0
    k, _, count = F._compact_kp(mask, key, key, pad)
    return k[:cap_elems], count <= cap_elems


def _mat_join(rk, rp, sk, sp, capacity: int):
    """Materializing join of the plans' middle stages.  Returns
    (JoinMaterialized, ok); a hole is keyed -3 on either route."""
    if _kernel_route(rk, rk.shape[0] + sk.shape[0], MAT_JOIN_MIN_ROWS):
        m, c, ok, orp, osp, ovf = rho_join_materialize_v3(rk, rp, sk, sp)
        return mergejoin.JoinMaterialized(m, c, ok, orp, osp), ovf == 0
    j = mergejoin.merge_join_materialize(rk, rp, sk, sp, capacity)
    # the exact core cuts at capacity: report it, never drop silently
    return j, j.matches <= capacity


def _count_join(rk, rp, sk, sp):
    """Count join: the keys-only pipeline, which drops the input pads, or
    the exact core.  Returns (matches, ok)."""
    if _kernel_route(rk, rk.shape[0] + sk.shape[0], 0):
        m, _, ovf = rho_join_count_v3(rk, rp, sk, sp, with_checksum=False)
        return m, ovf == 0
    j = mergejoin.merge_join_count(rk, rp, sk, sp)
    return j.matches, torch.ones((), dtype=torch.bool, device=rk.device)


def tpch_q3_fused(c: T.CustomerTable, o: T.OrdersTable, l: T.LineItemTable):
    """Q3: sigma(C) |x| sigma(O) -> rekey(Sp, Sp) -> |x| sigma(L)
    (tpch.cpp:36-115).  Returns (matches, ok).  Capacities about 1.5 times
    the TPC-H selectivities (mktsegment = BUILDING 20%, orderdate before
    1995-03-15 47%, shipdate from 1995-03-16 53%)."""
    nc, no, nl = c.num_tuples, o.num_tuples, l.num_tuples
    okd = _in_domain((c.key, MAX_KEY), (o.custkey, MAX_KEY),
                     (o.key, MAX_KEY), (l.key, MAX_KEY))
    ck, cp, ok1 = _compact(*F.q3_mask_customer(c), _cap(nc, 5, 16),
                           PAD_R_INPUT)
    okey, opay, ok2 = _compact(*F.q3_mask_orders(o), _cap(no, 5, 8),
                               PAD_S_INPUT)
    j1, okj = _mat_join(ck, cp, okey, opay, okey.shape[0])
    # copy_Sp_Sp (result_transformers.hpp:66+): key = payload = o_orderkey
    uk = torch.where(j1.key == -3, PAD_R_INPUT, j1.s_payload)
    lmask, lkey, _ = F.q3_mask_lineitem(l)
    lk, okc = _compact_keys(lmask, lkey, _cap(nl, 3, 4), PAD_S_INPUT)
    m, ok3 = _count_join(uk, j1.s_payload, lk, torch.zeros_like(lk))
    return m, okd & ok1 & ok2 & okj & okc & ok3


def tpch_q10_fused(c: T.CustomerTable, o: T.OrdersTable, l: T.LineItemTable,
                   n: T.NationTable):
    """Q10: C |x| sigma(O) -> nationkey rekey -> N |x| U -> orderkey rekey
    -> |x| sigma(L)  (tpch.cpp:117-216).  Returns (matches, ok).
    Selectivities: orderdate in one quarter about 3.8%, returnflag = R
    about 33%."""
    no, nl = o.num_tuples, l.num_tuples
    okd = _in_domain((c.key, MAX_KEY), (o.custkey, MAX_KEY),
                     (c.nationkey, MAX_KEY), (n.key, MAX_KEY),
                     (o.key, MAX_KEY), (l.key, MAX_KEY))
    ok_, op_, okf = _compact(*F.q10_mask_orders(o), _cap(no, 1, 16),
                             PAD_S_INPUT)
    j1, okj1 = _mat_join(c.key, c.rowid, ok_, op_, ok_.shape[0])
    valid = j1.key != -3
    # holes -> the S-side pad key, which either route drops (-3 would be a
    # domain violation to the pipeline)
    uk = torch.where(valid, c.nationkey[torch.where(valid, j1.r_payload,
                                                    0).long()], PAD_S_INPUT)
    up = torch.where(valid, j1.s_payload, 0)
    j2, okj2 = _mat_join(n.key, n.rowid, uk, up, uk.shape[0])
    valid = j2.key != -3
    vk = torch.where(valid, o.key[torch.where(valid, j2.s_payload,
                                              0).long()], PAD_R_INPUT)
    vp = torch.where(valid, j2.s_payload, 0)
    lmask, lkey, _ = F.q10_mask_lineitem(l)
    lk, okc = _compact_keys(lmask, lkey, _cap(nl, 1, 2), PAD_S_INPUT)
    m, okl = _count_join(vk, vp, lk, torch.zeros_like(lk))
    return m, okd & okf & okj1 & okj2 & okc & okl


def tpch_q12_fused(l: T.LineItemTable, o: T.OrdersTable):
    """Q12: O |x| sigma(L), count  (tpch.cpp:218-252).  Returns (matches,
    ok).  The five-way lineitem predicate keeps about 0.5% of the rows, so
    the probe side is compacted to 1/48 of the table before the keys-only
    count join."""
    nl = l.num_tuples
    okd = _in_domain((o.key, MAX_KEY), (l.key, MAX_KEY))
    lmask, lkey, _ = F.q12_mask_lineitem(l)
    lk, okc = _compact_keys(lmask, lkey, _cap(nl, 1, 48), PAD_S_INPUT)
    m, okl = _count_join(o.key, o.rowid, lk, torch.zeros_like(lk))
    return m, okd & okc & okl


def tpch_q19_fused(l: T.LineItemTable, p: T.PartTable):
    """Q19 as one keys-only count join on band-class composite keys.

    The residual folds into the join key (fused.py:181-226):

      * each residual disjunct fixes a (brand, container family, size)
        part conjunction; a part satisfies at most one, its class
        c in {1, 2, 3} (a class 0 part never appears in the result);
      * the quantity windows [1,11] / [10,20] / [20,30] split into five
        disjoint bands [1,9] [10,11] [12,19] [20] [21,30]; class c accepts
        a fixed set of bands (c=1: {0,1}, c=2: {1,2,3}, c=3: {3,4});
      * R' has one row per class-c part and accepted band, keyed
        partkey*8 + band (at most 3 rows a part, unique keys); S' is each
        prefiltered lineitem keyed partkey*8 + band(quantity).

    A pair matches iff it satisfies the whole Q19 predicate, so the count
    join is the query.  The probe side is compacted (about 4%) first.
    Returns (matches, ok)."""
    nl = l.num_tuples
    # partkey*8 + band must stay below MAX_KEY
    okd = _in_domain((p.key, MAX_KEY // 8), (l.partkey, MAX_KEY // 8))
    b, ct, sz = p.brand, p.container, p.size
    c1 = (b == T.P_BRAND_12) & (ct >= 1) & (ct <= 4) & (sz >= 1) & (sz <= 5)
    c2 = (b == T.P_BRAND_23) & (ct >= 5) & (ct <= 8) & (sz >= 1) & (sz <= 10)
    c3 = (b == T.P_BRAND_34) & (ct >= 9) & (ct <= 12) & (sz >= 1) & (sz <= 15)
    cls = torch.where(c1, 1, torch.where(c2, 2, torch.where(c3, 3, 0)))
    base = p.key * 8
    band0 = torch.where(cls == 1, 0, torch.where(
        cls == 2, 1, torch.where(cls == 3, 3, -1)))
    band1 = torch.where(cls == 1, 1, torch.where(
        cls == 2, 2, torch.where(cls == 3, 4, -1)))
    band2 = torch.where(cls == 2, 3, -1)
    rk = torch.cat([torch.where(bb >= 0, base + bb, PAD_R_INPUT)
                    for bb in (band0, band1, band2)]).to(torch.int32)
    lmask, lkey, _ = F.q19_mask_lineitem(l)
    q = l.quantity
    band = torch.where(q <= 9, 0, torch.where(
        q <= 11, 1, torch.where(q <= 19, 2, torch.where(q == 20, 3, 4))))
    lk, okc = _compact_keys(lmask, (lkey * 8 + band).to(torch.int32),
                            _cap(nl, 1, 16), PAD_S_INPUT)
    m, okj = _count_join(rk, torch.zeros_like(rk), lk, torch.zeros_like(lk))
    return m, okd & okc & okj

"""TPC-H Q3/Q10/Q12/Q19 staged physical plans (counterpart of
aqp_tpu/queries/tpch.py).

Each plan chains filter -> join -> result transform -> join (-> residual),
as the reference's hand-written plans do (tpch.cpp:36-309), and times its
phases `filter`, `join` and `materialize` and the `total` through
PhaseTimer on the tables' device.  The join algorithm is selected by
name, as run_join's.  The transforms are payload gathers; every gather
masks the rows it must not read to index 0 first, since a torch gather
raises on an index out of range where XLA clamps it.

Each join runs on the tables' device.  Its inputs are the filters'
full-length columns with the negative pad keys in the tail, so RHO's
pipeline reports them as domain violations and its ladder ends at the
exact core, as the reference's ladder does.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.joins.api import run_join
from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.queries import filters as F
from aqp_tpu_torch.queries import tables as T
from aqp_tpu_torch.relation import Relation
from aqp_tpu_torch.utils.timing import PhaseTimer, Timings


class QueryResult(NamedTuple):
    matches: int
    timings: Timings


def _run_join(rk, rp, sk, sp, algorithm, materialize):
    cfg = JoinConfig(materialize=materialize)
    res, _ = run_join(Relation(rk, rp), Relation(sk, sp), algorithm, cfg,
                      device=rk.device)
    return res


def _finish(pt: PhaseTimer, t0: float, rows_in: int, matches: int
            ) -> QueryResult:
    pt.t.phases["total"] = time.perf_counter() - t0
    pt.t.rows_in = rows_in
    pt.t.matches = matches
    return QueryResult(matches, pt.t)


def tpch_q3(c: T.CustomerTable, o: T.OrdersTable, l: T.LineItemTable,
            algorithm: str = "RHO") -> QueryResult:
    """Q3: sigma(customer) |x| sigma(orders) -> rekey -> |x|
    sigma(lineitem)  (tpch.cpp:36-115)."""
    pt = PhaseTimer(c.device)
    t0 = time.perf_counter()
    ck, cp, _ = pt.time_fn("filter", F.q3_filter_customer, c)
    ok, op, _ = pt.time_fn("filter", F.q3_filter_orders, o)
    j1 = pt.time_fn("join", _run_join, ck, cp, ok, op, algorithm, True)
    # copy_Sp_Sp (result_transformers.hpp:66+): key = payload = the S
    # payload, o_orderkey.  A hole's payload is 0, never a live orderkey
    # (>= 1), so it joins nothing.
    uk = up = pt.time_fn("materialize", lambda: j1.s_payload)
    lk, lp, _ = pt.time_fn("filter", F.q3_filter_lineitem, l)
    j2 = pt.time_fn("join", _run_join, uk, up, lk, lp, algorithm, False)
    return _finish(pt, t0, c.num_tuples + o.num_tuples + l.num_tuples,
                   int(j2.matches))


def _q10_transform1(nationkey_col, r_payload, s_payload, key):
    """copy_RpToKeySp: out.key = c_nationkey[R payload], out.payload = S
    payload (tpch.cpp:150-156).  Holes (key -3) keep the key -3."""
    valid = key != -3
    nk = nationkey_col[torch.where(valid, r_payload, 0).long()]
    return torch.where(valid, nk, -3), torch.where(valid, s_payload, 0)


def _q10_transform2(o_key_col, r_payload, s_payload, key):
    """copy_SpToTupleST: out = (o_orderkey[S payload], orders row id)
    (tpch.cpp:176-182)."""
    valid = key != -3
    okey = o_key_col[torch.where(valid, s_payload, 0).long()]
    return torch.where(valid, okey, -3), torch.where(valid, s_payload, 0)


def tpch_q10(c: T.CustomerTable, o: T.OrdersTable, l: T.LineItemTable,
             n: T.NationTable, algorithm: str = "RHO") -> QueryResult:
    """Q10: C |x| sigma(orders) -> nationkey rekey -> N |x| U -> orderkey
    rekey -> |x| sigma(lineitem)  (tpch.cpp:117-216)."""
    pt = PhaseTimer(c.device)
    t0 = time.perf_counter()
    ok, op, _ = pt.time_fn("filter", F.q10_filter_orders, o)
    j1 = pt.time_fn("join", _run_join, c.key, c.rowid, ok, op, algorithm,
                    True)
    uk, up = pt.time_fn("materialize", _q10_transform1, c.nationkey,
                        j1.r_payload, j1.s_payload, j1.key)
    j2 = pt.time_fn("join", _run_join, n.key, n.rowid, uk, up, algorithm,
                    True)
    vk, vp = pt.time_fn("materialize", _q10_transform2, o.key,
                        j2.r_payload, j2.s_payload, j2.key)
    lk, lp, _ = pt.time_fn("filter", F.q10_filter_lineitem, l)
    j3 = pt.time_fn("join", _run_join, vk, vp, lk, lp, algorithm, False)
    return _finish(pt, t0, c.num_tuples + o.num_tuples + l.num_tuples
                   + n.num_tuples, int(j3.matches))


def tpch_q12(l: T.LineItemTable, o: T.OrdersTable,
             algorithm: str = "RHO") -> QueryResult:
    """Q12: O |x| sigma(lineitem), one join, count  (tpch.cpp:218-252)."""
    pt = PhaseTimer(l.device)
    t0 = time.perf_counter()
    lk, lp, _ = pt.time_fn("filter", F.q12_filter_lineitem, l)
    j = pt.time_fn("join", _run_join, o.key, o.rowid, lk, lp, algorithm,
                   False)
    return _finish(pt, t0, l.num_tuples + o.num_tuples, int(j.matches))


def _q19_residual(p, l, key, r_payload, s_payload, cap: int):
    """Compact the join's output rows, then count those that pass the
    exact residual: the output is region-chunked with holes, so compacting
    first keeps the row-id gathers at the size of the live rows."""
    cm = mergejoin.compact_matches(key != -3, key, r_payload, s_payload,
                                   capacity=cap)
    valid = cm.key != -3
    return F.q19_residual_predicate(p, l, cm.r_payload, cm.s_payload,
                                    valid).sum()


def tpch_q19(l: T.LineItemTable, p: T.PartTable,
             algorithm: str = "RHO") -> QueryResult:
    """Q19: sigma(part) |x| sigma(lineitem) materialized, then the exact
    disjunctive residual per output row through row-id lookups
    (tpch.cpp:254-309)."""
    pt = PhaseTimer(l.device)
    t0 = time.perf_counter()
    pk, pp, _ = pt.time_fn("filter", F.q19_filter_part, p)
    lk, lp, _ = pt.time_fn("filter", F.q19_filter_lineitem, l)
    j = pt.time_fn("join", _run_join, pk, pp, lk, lp, algorithm, True)
    # with unique part keys each lineitem row matches at most once
    res_cap = max(128, -(-lk.shape[0] // 128) * 128)
    matches = int(pt.time_fn("filter", _q19_residual, p, l, j.key,
                             j.r_payload, j.s_payload, res_cap))
    return _finish(pt, t0, l.num_tuples + p.num_tuples, matches)

"""Per-query predicate filters (counterpart of aqp_tpu/queries/filters.py).

Each filter is an elementwise predicate giving a mask, then a stable
compaction into (key, payload) relation columns of the table's full
length.  Each `q*_filter_*` returns (key, payload, count): the rows that
pass first, in table order, then the pad key with payload 0.  The build
side pads with PAD_R_SIDE and the probe side with PAD_S_SIDE, which are
negative and distinct, so a pad never joins anything.

The predicates follow the reference's Q{3,10,12,19}Predicates.hpp; the
Q19 residual is the exact disjunctive predicate, evaluated per join output
row through row-id lookups into both tables.
"""

from __future__ import annotations

import torch

from aqp_tpu_torch.queries import tables as T

PAD_R_SIDE = -3   # build-side pads
PAD_S_SIDE = -4   # probe-side pads (distinct: pads must never join)


def _compact_kp(mask, key, payload, pad_key=PAD_S_SIDE):
    """Stable compaction of the rows where `mask` into columns of the
    input's length: those rows first, in order, then `pad_key` with
    payload 0.  Returns (key, payload, count as a 0-dim int64 tensor).
    A stable partition by one scatter a column, each row to its own
    place (the rows that pass to their rank, the others after them in
    order), with no host synchronisation."""
    n = key.shape[0]
    kept = torch.cumsum(mask, 0)        # rows that pass, up to each row
    count = mask.sum()
    idx = torch.arange(n, device=key.device)
    dest = torch.where(mask, kept - 1, count + idx - kept)
    live = idx < count
    k = torch.empty_like(key).scatter_(0, dest, key)
    p = torch.empty_like(payload).scatter_(0, dest, payload)
    return torch.where(live, k, pad_key), torch.where(live, p, 0), count


# --- Q3 (Q3Predicates.hpp:26-54) ---

def q3_mask_customer(c: T.CustomerTable):
    return c.mktsegment == T.MKT_BUILDING, c.key, c.rowid


def q3_filter_customer(c: T.CustomerTable):
    return _compact_kp(*q3_mask_customer(c), PAD_R_SIDE)


def q3_mask_orders(o: T.OrdersTable):
    """out.key = o_custkey, out.payload = o_orderkey (the key field)."""
    return o.orderdate < T.TS_1995_03_15, o.custkey, o.key


def q3_filter_orders(o: T.OrdersTable):
    return _compact_kp(*q3_mask_orders(o))


def q3_mask_lineitem(l: T.LineItemTable):
    return l.shipdate >= T.TS_1995_03_16, l.key, l.rowid


def q3_filter_lineitem(l: T.LineItemTable):
    return _compact_kp(*q3_mask_lineitem(l))


# --- Q10 (Q10Predicates.hpp:27-45) ---

def q10_mask_orders(o: T.OrdersTable):
    """out.key = o_custkey, out.payload = the orders row id."""
    mask = (o.orderdate >= T.TS_1993_10_01) & (o.orderdate < T.TS_1994_01_01)
    return mask, o.custkey, o.rowid


def q10_filter_orders(o: T.OrdersTable):
    return _compact_kp(*q10_mask_orders(o))


def q10_mask_lineitem(l: T.LineItemTable):
    return l.returnflag == T.L_RETURNFLAG_R, l.key, l.rowid


def q10_filter_lineitem(l: T.LineItemTable):
    return _compact_kp(*q10_mask_lineitem(l))


# --- Q12 (Q12Predicates.hpp:23-32) ---

def q12_mask_lineitem(l: T.LineItemTable):
    mask = (
        ((l.shipmode == T.L_SHIPMODE_MAIL) | (l.shipmode == T.L_SHIPMODE_SHIP))
        & (l.commitdate < l.receiptdate)
        & (l.shipdate < l.commitdate)
        & (l.receiptdate >= T.TS_1994_01_01)
        & (l.receiptdate < T.TS_1995_01_01)
    )
    return mask, l.key, l.rowid


def q12_filter_lineitem(l: T.LineItemTable):
    return _compact_kp(*q12_mask_lineitem(l))


# --- Q19 (Q19Predicates.hpp:27-50 prefilters; :58-78 residual) ---

def q19_mask_lineitem(l: T.LineItemTable):
    """Relaxed prefilter; out.key = l_partkey, out.payload = the lineitem
    row id."""
    mask = (
        (l.quantity >= 1)
        & (l.quantity <= 30)
        & ((l.shipmode == T.L_SHIPMODE_AIR)
           | (l.shipmode == T.L_SHIPMODE_AIR_REG))
        & (l.shipinstruct == T.L_SHIPINSTRUCT_DELIVER_IN_PERSON)
    )
    return mask, l.partkey, l.rowid


def q19_filter_lineitem(l: T.LineItemTable):
    return _compact_kp(*q19_mask_lineitem(l))


def q19_mask_part(p: T.PartTable):
    mask = (
        ((p.brand == T.P_BRAND_12) | (p.brand == T.P_BRAND_23)
         | (p.brand == T.P_BRAND_34))
        & (p.container >= 1)
        & (p.container <= 12)
        & (p.size >= 1)
        & (p.size <= 15)
    )
    return mask, p.key, p.rowid


def q19_filter_part(p: T.PartTable):
    return _compact_kp(*q19_mask_part(p), PAD_R_SIDE)


def q19_residual_predicate(p: T.PartTable, l: T.LineItemTable, part_rowid,
                           li_rowid, valid):
    """The exact disjunctive residual per join output row, through row-id
    lookups into both tables (q19FinalPredicate, Q19Predicates.hpp:58-78).
    Rows that are not `valid` read row 0 and are false."""
    pr = torch.where(valid, part_rowid, 0).long()
    lr = torch.where(valid, li_rowid, 0).long()
    brand = p.brand[pr]
    container = p.container[pr]
    size = p.size[pr]
    qty = l.quantity[lr]

    p1 = (
        (brand == T.P_BRAND_12)
        & (container >= 1) & (container <= 4)      # SM_CASE..SM_PKG
        & (size >= 1) & (size <= 5)
        & (qty >= 1) & (qty <= 11)
    )
    p2 = (
        (brand == T.P_BRAND_23)
        & (container >= 5) & (container <= 8)      # MED_BAG..MED_PACK
        & (size >= 1) & (size <= 10)
        & (qty >= 10) & (qty <= 20)
    )
    p3 = (
        (brand == T.P_BRAND_34)
        & (container >= 9) & (container <= 12)     # LG_CASE..LG_PKG
        & (size >= 1) & (size <= 15)
        & (qty >= 20) & (qty <= 30)
    )
    return valid & (p1 | p2 | p3)

"""The port's TPC-H layer (tables, filters, the staged and fused Q3, Q10,
Q12 and Q19 plans) against the JAX package's, on the CPU.

Both packages run on the same tables: the reference's
generate_tpch_tables carried across as numpy arrays (the port's generator
draws other bits).  Masks, filters and the residual are compared element
by element; the plans' counts are integers and must equal the reference's
and a numpy oracle exactly.  The fused plans run on their plain route and
on their kernel route, forced on the CPU by replacing
fused._kernel_route, so that the kernels' plain versions (the window
compactor and the scatters, K1, K2, K3 and K3M) serve them.  The file
takes about 40 s on one worker alone (64 s on one core), and 334 s
beside five other workers in the repository's full CPU test run.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.queries import fused as jfused
from aqp_tpu.queries import filters as jF
from aqp_tpu.queries import generate_tpch_tables as jgenerate
from aqp_tpu.queries import tables as jT
from aqp_tpu.queries import tpch as jtpch
from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.joins.api import run_join
from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.ops.kernels import lanecompact, rho3
from aqp_tpu_torch.queries import filters as F
from aqp_tpu_torch.queries import fused
from aqp_tpu_torch.queries import tables as T
from aqp_tpu_torch.queries import tpch
from aqp_tpu_torch.relation import Relation

CLASSES = (T.LineItemTable, T.OrdersTable, T.CustomerTable, T.PartTable,
           T.NationTable)
QUERIES = ("q3", "q10", "q12", "q19")
# 0.0128 makes every compaction of the fused plans whole 128-wide rows
# (1,920 customers, 19,200 orders), so the kernel route compacts every
# side with the window compactor and the scatters, the pair too
KERNEL_SCALES = (0.01, 0.0128)


def _np(t):
    return {k: np.asarray(v) for k, v in t.__dict__.items()}


def _carry(jtables):
    """The reference's tables as numpy dicts and as the port's tables."""
    arrays = [_np(t) for t in jtables]
    return arrays, [cls.from_numpy(a, device="cpu")
                    for cls, a in zip(CLASSES, arrays)]


_CACHE = {}


def _tables(scale, seed=7):
    """(reference tables, numpy dicts, port tables) at `scale`."""
    key = (scale, seed)
    if key not in _CACHE:
        jt = jgenerate(scale=scale, seed=seed)
        _CACHE[key] = (jt, *_carry(jt))
    return _CACHE[key]


@pytest.fixture(scope="module")
def data():
    return _tables(0.002)


# --- numpy oracle --------------------------------------------------------

def _q12_mask(l):
    return (np.isin(l["shipmode"], [T.L_SHIPMODE_MAIL, T.L_SHIPMODE_SHIP])
            & (l["commitdate"] < l["receiptdate"])
            & (l["shipdate"] < l["commitdate"])
            & (l["receiptdate"] >= T.TS_1994_01_01)
            & (l["receiptdate"] < T.TS_1995_01_01))


def oracle(name, l, o, c, p, n):
    if name == "q3":
        cust = c["key"][c["mktsegment"] == T.MKT_BUILDING]
        om = (o["orderdate"] < T.TS_1995_03_15) & np.isin(o["custkey"], cust)
        lm = l["shipdate"] >= T.TS_1995_03_16
        return int((lm & np.isin(l["key"], o["key"][om])).sum())
    if name == "q10":
        cust = c["key"][np.isin(c["nationkey"], n["key"])]
        om = ((o["orderdate"] >= T.TS_1993_10_01)
              & (o["orderdate"] < T.TS_1994_01_01)
              & np.isin(o["custkey"], cust))
        lm = l["returnflag"] == T.L_RETURNFLAG_R
        return int((lm & np.isin(l["key"], o["key"][om])).sum())
    if name == "q12":
        return int((_q12_mask(l) & np.isin(l["key"], o["key"])).sum())
    # q19: each prefiltered lineitem's part by key, then the residual
    order = np.argsort(p["key"])
    at = np.searchsorted(p["key"][order], l["partkey"]).clip(
        max=len(order) - 1)
    hit = p["key"][order][at] == l["partkey"]
    row = order[at]
    brand, cont, size = (p[f][row] for f in ("brand", "container", "size"))
    q = l["quantity"]
    lm = ((q >= 1) & (q <= 30)
          & np.isin(l["shipmode"], [T.L_SHIPMODE_AIR, T.L_SHIPMODE_AIR_REG])
          & (l["shipinstruct"] == T.L_SHIPINSTRUCT_DELIVER_IN_PERSON))
    p1 = ((brand == 1) & (cont >= 1) & (cont <= 4) & (size >= 1)
          & (size <= 5) & (q <= 11))
    p2 = ((brand == 2) & (cont >= 5) & (cont <= 8) & (size >= 1)
          & (size <= 10) & (q >= 10) & (q <= 20))
    p3 = ((brand == 3) & (cont >= 9) & (cont <= 12) & (size >= 1)
          & (size <= 15) & (q >= 20))
    return int((lm & hit & (p1 | p2 | p3)).sum())


def _args(name, l, o, c, p, n):
    return {"q3": (c, o, l), "q10": (c, o, l, n), "q12": (l, o),
            "q19": (l, p)}[name]


def _staged(mod, name):
    return getattr(mod, f"tpch_{name}")


def _fused(mod, name):
    return getattr(mod, f"tpch_{name}_fused")


def tpch_plan(name, tt, algorithm="RHO"):
    return _staged(tpch, name)(*_args(name, *tt), algorithm=algorithm)


def _np_t(t):
    return {f.name: getattr(t, f.name).numpy()
            for f in dataclasses.fields(t)}


# --- masks, filters, the residual ----------------------------------------

FILTERS = (("q3_filter_customer", 2), ("q3_filter_orders", 1),
           ("q3_filter_lineitem", 0), ("q10_filter_orders", 1),
           ("q10_filter_lineitem", 0), ("q12_filter_lineitem", 0),
           ("q19_filter_lineitem", 0), ("q19_filter_part", 3))


@pytest.mark.parametrize("name,table", FILTERS, ids=[f for f, _ in FILTERS])
def test_filter_matches_reference(data, name, table):
    jt, _, tt = data
    mask_name = name.replace("_filter_", "_mask_")
    jm = getattr(jF, mask_name)(jt[table])
    tm = getattr(F, mask_name)(tt[table])
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jk, jp, jc = getattr(jF, name)(jt[table])
    tk, tp, tc = getattr(F, name)(tt[table])
    assert int(tc) == int(jc) > 0
    assert tk.dtype == tp.dtype == torch.int32
    # live rows in table order, then the pad key with payload 0
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    pad = F.PAD_R_SIDE if table in (2, 3) else F.PAD_S_SIDE
    assert (tk.numpy()[int(tc):] == pad).all()
    assert not tp.numpy()[int(tc):].any()


def test_compact_kp_empty_and_full():
    key = torch.arange(1, 9, dtype=torch.int32)
    for mask, count in ((torch.zeros(8, dtype=torch.bool), 0),
                        (torch.ones(8, dtype=torch.bool), 8)):
        k, p, c = F._compact_kp(mask, key, key * 10, F.PAD_R_SIDE)
        assert int(c) == count
        assert k.tolist() == (key.tolist() if count else [F.PAD_R_SIDE] * 8)
        assert p.tolist() == ((key * 10).tolist() if count else [0] * 8)
    k, p, c = F._compact_kp(torch.zeros(0, dtype=torch.bool),
                            key[:0], key[:0])
    assert k.numel() == p.numel() == int(c) == 0


def test_q19_residual_matches_reference(data):
    jt, _, tt = data
    rng = np.random.default_rng(3)
    n = 4096
    pr = rng.integers(0, jt[3].key.shape[0], n).astype(np.int32)
    lr = rng.integers(0, jt[0].key.shape[0], n).astype(np.int32)
    valid = rng.random(n) < 0.8
    # rows that are not valid carry row ids past the tables: masked first
    pr[~valid] = 1 << 30
    lr[~valid] = -5
    want = np.asarray(jF.q19_residual_predicate(
        jt[3], jt[0], jnp.asarray(pr), jnp.asarray(lr), jnp.asarray(valid)))
    got = F.q19_residual_predicate(tt[3], tt[0], torch.from_numpy(pr),
                                   torch.from_numpy(lr),
                                   torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


# --- the generator --------------------------------------------------------

def test_generator_sizes_dtypes_ranges_and_codes():
    scale = 0.002
    jt = jgenerate(scale=scale, seed=7)
    tt = T.generate_tpch_tables(scale=scale, seed=7, device="cpu")
    for j, t in zip(jt, tt):
        assert type(t).__name__ == type(j).__name__
        for k, v in _np(j).items():
            col = getattr(t, k)
            assert col.shape == v.shape, k
            assert col.numpy().dtype == v.dtype, k
    l, o, c, p, n = (_np_t(t) for t in tt)
    NO, NC, NP = o["key"].size, c["key"].size, p["key"].size
    for d in (l, o, c, p, n):
        np.testing.assert_array_equal(d["rowid"], np.arange(d["key"].size))
    # dense permuted primary keys, uniform foreign keys into them
    for d in (o, c, p):
        np.testing.assert_array_equal(np.sort(d["key"]),
                                      np.arange(1, d["key"].size + 1))
    np.testing.assert_array_equal(n["key"], np.arange(25))
    ranges = {
        "l.key": (l["key"], 1, NO), "l.partkey": (l["partkey"], 1, NP),
        "l.quantity": (l["quantity"], 1, 50),
        "l.shipmode": (l["shipmode"], 1, 7),
        "l.shipinstruct": (l["shipinstruct"], 1, 4),
        "o.custkey": (o["custkey"], 1, NC),
        "c.mktsegment": (c["mktsegment"], 1, 5),
        "c.nationkey": (c["nationkey"], 0, 24),
        "p.brand": (p["brand"], 1, 5), "p.size": (p["size"], 1, 50),
        "p.container": (p["container"], 1, 16),
    }
    for what, (col, lo, hi) in ranges.items():
        assert col.min() == lo and col.max() == hi, what
    for col in (l["shipdate"], l["commitdate"], l["receiptdate"],
                o["orderdate"]):
        assert col.min() >= T.TS_1992_01_01 and col.max() < T.TS_1998_12_01
    assert set(np.unique(l["returnflag"]).tolist()) == {65, 78, 82}
    # the same seed draws the same tables; another seed other ones
    again = T.generate_tpch_tables(scale=scale, seed=7, device="cpu")
    other = T.generate_tpch_tables(scale=scale, seed=8, device="cpu")
    assert torch.equal(again[0].key, tt[0].key)
    assert not torch.equal(other[0].key, tt[0].key)
    # and the plans answer on them as the oracle does
    for name in QUERIES:
        want = oracle(name, l, o, c, p, n)
        assert tpch_plan(name, tt).matches == want, name
        m, ok = _fused(fused, name)(*_args(name, *tt))
        assert bool(ok) and int(m) == want, name



def test_tables_carry_the_references_columns(data):
    jt, arrays, tt = data
    for j, a, t in zip(jt, arrays, tt):
        assert t.num_tuples == j.num_tuples
        for k, v in a.items():
            np.testing.assert_array_equal(getattr(t, k).numpy(), v)
        with pytest.raises(dataclasses.FrozenInstanceError):
            t.key = t.key


# --- the staged plans ----------------------------------------------------

@pytest.mark.parametrize("alg", ["RHO", "PSM", "PHT"])
@pytest.mark.parametrize("name", QUERIES)
def test_staged_plan_matches_reference(data, name, alg):
    jt, arrays, tt = data
    want = oracle(name, *arrays)
    ref = _staged(jtpch, name)(*_args(name, *jt), algorithm=alg)
    got = tpch_plan(name, tt, alg)
    assert got.matches == ref.matches == want
    t = got.timings
    assert t.matches == want
    assert t.rows_in == ref.timings.rows_in
    assert {"filter", "join", "total"} <= set(t.phases)
    assert all(v >= 0 for v in t.phases.values())


# --- the fused plans -----------------------------------------------------

def _force_kernel_route(monkeypatch):
    monkeypatch.setattr(fused, "_kernel_route", lambda t, rows, least: True)


def _spy(monkeypatch, names):
    """Count the calls the fused plans make to the kernel-route cores."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def wrap(*a, _f=getattr(fused, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(fused, name, wrap)
    return calls


CORES = ("compact_kp_fast", "compact_k_fast", "rho_join_count_v3",
         "rho_join_materialize_v3")


@pytest.mark.parametrize("name", QUERIES)
def test_fused_plain_route_matches_reference(data, name, monkeypatch):
    jt, arrays, tt = data
    calls = _spy(monkeypatch, CORES)
    want = oracle(name, *arrays)
    jm, jok = _fused(jfused, name)(*_args(name, *jt))
    m, ok = _fused(fused, name)(*_args(name, *tt))
    assert bool(jok) and bool(ok)
    assert int(m) == int(jm) == want
    assert _staged(jtpch, name)(*_args(name, *jt)).matches == want
    assert not any(calls.values()), calls      # the CPU takes the plain route


@pytest.mark.parametrize("scale", KERNEL_SCALES)
def test_fused_kernel_route_matches_reference(scale, monkeypatch):
    jt, arrays, tt = _tables(scale)
    _force_kernel_route(monkeypatch)
    calls = _spy(monkeypatch, CORES)
    for name in QUERIES:
        want = oracle(name, *arrays)
        jm, jok = _fused(jfused, name)(*_args(name, *jt))
        m, ok = _fused(fused, name)(*_args(name, *tt))
        assert bool(jok) and bool(ok), name
        assert int(m) == int(jm) == want, name
        if scale == 0.01:   # the reference's staged plans, at one scale
            assert _staged(jtpch, name)(*_args(name, *jt)).matches == want
    assert calls["rho_join_materialize_v3"] == 3       # Q3 once, Q10 twice
    assert calls["rho_join_count_v3"] == 4
    # whole rows only: at 0.0128 every side; at 0.01 Q3's lineitem (60,012
    # elements) and the (key, payload) sides compact on the plain route
    whole = scale == 0.0128
    assert calls["compact_k_fast"] == (4 if whole else 3)
    assert calls["compact_kp_fast"] == (3 if whole else 0)


def test_fused_kernel_route_launches_no_kernel_on_the_cpu(monkeypatch):
    _, _, tt = _tables(0.01)
    _force_kernel_route(monkeypatch)
    for counter in (rho3.LAUNCHES, lanecompact.LAUNCHES):
        for k in counter:
            counter[k] = 0
    fused.tpch_q12_fused(tt[0], tt[1])
    assert not any(rho3.LAUNCHES.values())
    assert not any(lanecompact.LAUNCHES.values())


def test_kernel_route_rule():
    t = torch.zeros(4, dtype=torch.int32)
    meta = t.to("meta")
    assert not fused._kernel_route(t, 1 << 30, 0)            # the CPU
    assert not fused._kernel_route(meta, 1 << 30, 0)
    # the reference's thresholds and capacities
    assert (fused.COMPACT_MIN_ROWS, fused.MAT_JOIN_MIN_ROWS) == (32768,
                                                                 1 << 23)
    for n, num, den in ((60_012_150, 1, 48), (1_500_000, 5, 16),
                        (15_000_000, 5, 8), (1000, 1, 2), (40000, 3, 4)):
        assert fused._cap(n, num, den) == jfused._cap(n, num, den)


def _all_pass_q12(n=40000):
    """A lineitem table whose every row passes Q12's filter, far above the
    fused plan's 1/48 buffer, and orders for it."""
    rng = np.random.default_rng(5)
    ship = np.full(n, T.TS_1994_01_01 + 86400 * 10, np.int32)
    l = dict(key=(rng.integers(0, 1000, n) + 1).astype(np.int32),
             rowid=np.arange(n, dtype=np.int32), shipdate=ship,
             commitdate=ship + 86400, receiptdate=ship + 2 * 86400,
             shipmode=np.ones(n, np.uint8),
             partkey=np.ones(n, np.int32), quantity=np.ones(n, np.int32),
             shipinstruct=np.ones(n, np.uint8),
             returnflag=np.full(n, 65, np.uint8))
    o = dict(key=np.arange(1, 1001, dtype=np.int32),
             rowid=np.arange(1000, dtype=np.int32),
             orderdate=np.zeros(1000, np.int32),
             custkey=np.ones(1000, np.int32))
    return l, o


def test_fused_q12_over_its_bound_is_not_ok(monkeypatch):
    l, o = _all_pass_q12()
    jl, jo = jT.LineItemTable(**{k: jnp.asarray(v) for k, v in l.items()}), \
        jT.OrdersTable(**{k: jnp.asarray(v) for k, v in o.items()})
    tl = T.LineItemTable.from_numpy(l, device="cpu")
    to_ = T.OrdersTable.from_numpy(o, device="cpu")
    assert not bool(jfused.tpch_q12_fused(jl, jo)[1])
    assert not bool(fused.tpch_q12_fused(tl, to_)[1])
    _force_kernel_route(monkeypatch)
    assert not bool(fused.tpch_q12_fused(tl, to_)[1])
    # the staged plan answers
    assert tpch.tpch_q12(tl, to_).matches == l["key"].size


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_fused_key_outside_the_domain_is_not_ok(data, route, monkeypatch):
    """A key the pipeline would take for a pad (or, on the plain route,
    an R key equal to the S pad) makes ok False, never a wrong count."""
    _, arrays, _ = data
    if route == "kernel":
        _force_kernel_route(monkeypatch)
    l, o = dict(arrays[0]), dict(arrays[1])
    for bad in (rho3.PAD_S_INPUT, -7):
        o["key"] = arrays[1]["key"].copy()
        o["key"][0] = bad
        tl = T.LineItemTable.from_numpy(l, device="cpu")
        to_ = T.OrdersTable.from_numpy(o, device="cpu")
        assert not bool(fused.tpch_q12_fused(tl, to_)[1])
    l["partkey"] = arrays[0]["partkey"].copy()
    l["partkey"][0] = rho3.MAX_KEY // 8
    tt = T.LineItemTable.from_numpy(l, device="cpu")
    p = T.PartTable.from_numpy(arrays[3], device="cpu")
    assert not bool(fused.tpch_q19_fused(tt, p)[1])


# --- a hole's payloads are 0 ---------------------------------------------

def _hole_payloads(key, r_payload, s_payload):
    holes = key == -3
    return int(holes.sum()), int(r_payload[holes].abs().sum()
                                 + s_payload[holes].abs().sum())


def test_holes_carry_payload_zero():
    """A hole's payloads are 0 on the dense path, the pipeline and the
    exact core: staged Q3 feeds the S payloads as the next join's R keys,
    and no hole may carry a live orderkey there."""
    rng = np.random.default_rng(9)
    nr, ns = 3000, 12000
    rk = (rng.permutation(nr) + 1).astype(np.int32)
    rp = rng.integers(1, 1 << 30, nr).astype(np.int32)
    sk = rng.integers(1, 2 * nr, ns).astype(np.int32)     # half miss
    sp = rng.integers(1, 1 << 30, ns).astype(np.int32)
    R = Relation.from_numpy(rk, rp, device="cpu")
    S = Relation.from_numpy(sk, sp, device="cpu")
    truth = int(np.isin(sk, rk).sum())
    outs = {}
    dense, _ = run_join(R, S, "RHO", JoinConfig(materialize=True),
                        device="cpu")
    outs["dense"] = (dense.matches, dense.key, dense.r_payload,
                     dense.s_payload)
    m, _, k, orp, osp, ovf = rho3.rho_join_materialize_v3(
        R.key, R.payload, S.key, S.payload)
    assert int(ovf) == 0
    outs["pipeline"] = (m, k, orp, osp)
    ex = mergejoin.merge_join_materialize(R.key, R.payload, S.key,
                                          S.payload, ns)
    outs["exact core"] = (ex.matches, ex.key, ex.r_payload, ex.s_payload)
    cm = mergejoin.compact_matches(k != -3, k, orp, osp, ns)
    outs["compact_matches"] = (cm.matches, cm.key, cm.r_payload,
                               cm.s_payload)
    for route, (m, k, orp, osp) in outs.items():
        holes, nonzero = _hole_payloads(k, orp, osp)
        assert int(m) == truth, route
        assert holes == k.numel() - truth > 0, route
        assert nonzero == 0, route


def test_staged_q3_first_join_holes(data):
    """Staged Q3's first join ends at the exact core (the filters' pads
    are domain violations to the pipeline): its hole payloads are 0."""
    _, _, tt = data
    c, o = tt[2], tt[1]
    ck, cp, _ = F.q3_filter_customer(c)
    ok, op, _ = F.q3_filter_orders(o)
    j1 = tpch._run_join(ck, cp, ok, op, "RHO", True)
    holes, nonzero = _hole_payloads(j1.key, j1.r_payload, j1.s_payload)
    assert holes > 0 and nonzero == 0
    assert int(j1.s_payload[j1.key != -3].min()) >= 1


def test_plans_run_on_the_tables_device(data):
    """The staged plans hand run_join the tables' device: on the CPU they
    answer; without a CUDA device the port's entry points raise."""
    _, arrays, tt = data
    assert tpch_plan("q12", tt).matches == oracle("q12", *arrays)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    for call in (lambda: T.generate_tpch_tables(0.001),
                 lambda: T.OrdersTable.from_numpy(arrays[1])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

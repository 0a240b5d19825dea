"""The port's last six drivers (aqp_tpu_torch/experiments: rho_phases,
roofline, scan_bench, aggregate_bench, tpch_bench, cracking) against the
JAX package's (experiments/*.py), on the CPU.

Each JAX driver is run with its data, engines and timing replaced by
recorders (nothing of it is computed) to read the constants it holds in
its functions: sizes, seeds, sweeps, capacities, the TPC-H queries and
their throughput row counts, the cracking variants; the port's must equal
them.  Each port driver then runs end to end at --small --device cpu (the
kernels' plain versions) into tmp_path, some at sizes cut further for the
suite's time, its CSV header the JAX driver's and its answers held to the
JAX package on the same inputs, carried across as numpy."""

import ast
import itertools
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from aqp_tpu_torch.experiments import (aggregate_bench, cracking,
                                       rho_phases, roofline, scan_bench,
                                       tpch_bench)

ROOT = Path(__file__).resolve().parents[1]
SMALL_GEOM = dict(block_rows=128, slot_rows=8, f1=20, f2=4, kd_slot_rows=16)
DRIVERS = ("rho_phases", "roofline", "scan_bench", "aggregate_bench",
           "tpch_bench", "cracking")
TPCH_SCALE = 0.002   # the smallest store whose four queries all match rows


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's PyTorch work: the suite runs
    six workers on the host's cores, and the plain versions' many-thread
    passes slow every worker down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_header(name):
    """The first string constant the JAX driver writes (its CSV header)."""
    tree = ast.parse((ROOT / "experiments" / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "write" and node.args
                and isinstance(node.args[0], ast.Constant)):
            return node.args[0].value.rstrip("\n")
    raise AssertionError(f"no CSV header in experiments/{name}.py")


def _csv(path):
    lines = Path(path).read_text().splitlines()
    return lines[0], [line.split(",") for line in lines[1:]]


@pytest.fixture
def jax_driver(monkeypatch, tmp_path):
    """Import a JAX driver with ensure_platform_from_env a no-op, in
    tmp_path (the JAX drivers write under results/)."""
    import importlib

    import aqp_tpu.utils

    monkeypatch.setattr(aqp_tpu.utils, "ensure_platform_from_env",
                        lambda: None)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "results").mkdir()
    return lambda name: importlib.import_module(f"experiments.{name}")


def _fake_jax(platform="tpu", **kw):
    return types.SimpleNamespace(
        devices=lambda: [types.SimpleNamespace(platform=platform)],
        block_until_ready=lambda x: x, device_put=lambda x: x, **kw)


# ---------------------------------------------------------------------------
# The JAX drivers' constants


@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
def test_scan_matrix_equals_the_reference(jax_driver, monkeypatch, small):
    """Every family's (family, mode, engine, rows, selectivity, residency)
    rows, in order: the JAX driver's on a TPU (both engines), the port's on
    any device (its CPU runs the pallas engine's plain versions)."""
    ref = jax_driver("scan_bench")
    monkeypatch.setattr(ref, "jax", _fake_jax())
    monkeypatch.setattr(ref, "make_col", lambda n: np.zeros(1, np.uint8))
    monkeypatch.setattr(ref, "make_fns", lambda *a: {
        m: (lambda *x: (0,), int, 0) for m in ref.MODES})
    monkeypatch.setattr(ref, "run_config_safe", lambda *a: (1.0, 1.0, 1.0))
    monkeypatch.setattr(ref, "time_async", lambda *a: 1.0)
    monkeypatch.setattr(scan_bench, "make_col",
                        lambda n, device: torch.zeros(1, dtype=torch.uint8))
    monkeypatch.setattr(scan_bench, "make_fns", lambda *a: {
        m: (lambda *x: (0,), int, 0) for m in scan_bench.MODES})
    monkeypatch.setattr(scan_bench, "run_config",
                        lambda *a: (1.0, 1.0, 1.0, 0))
    monkeypatch.setattr(scan_bench, "mean_ms", lambda *a: (1.0, 0))
    assert scan_bench.MODES == ref.MODES
    for fam in ("selectivity", "scaleup", "residency"):
        want, got = [], []
        getattr(ref, f"family_{fam}")(small, 1, want)
        getattr(scan_bench, f"family_{fam}")(small, 1, got,
                                             torch.device("cpu"))
        assert want and [r[:6] for r in got] == [r[:6] for r in want], fam


@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
def test_aggregate_sweep_equals_the_reference(jax_driver, monkeypatch,
                                              small):
    """n, the group counts, each capacity and the seeds: the JAX driver's
    draws and calls recorded, the port's draw recorded alike."""
    import aqp_tpu.ops.aggregate
    import aqp_tpu.ops.pallas.aggpipe

    ref = jax_driver("aggregate_bench")
    draws, caps = [], []

    def randint(seed, shape, lo, hi, dtype):
        draws.append((shape[0], hi, seed))
        return np.zeros(1, np.int32)

    def engine(key, pay, cap):
        caps.append(cap)
        return types.SimpleNamespace(num_groups=0)

    monkeypatch.setattr(ref, "jax", _fake_jax(random=types.SimpleNamespace(
        PRNGKey=lambda s: s, randint=randint)))
    monkeypatch.setattr(ref, "hard_sync", lambda x: x)
    monkeypatch.setattr(ref, "timeit", lambda fn, iters: 1.0)
    monkeypatch.setattr(aqp_tpu.ops.aggregate, "groupby_aggregate", engine)
    monkeypatch.setattr(aqp_tpu.ops.pallas.aggpipe,
                        "groupby_aggregate_routed_auto", engine)
    monkeypatch.setattr(sys, "argv", ["aggregate_bench.py", "--csv",
                                      "ref.csv"] + ["--small"] * small)
    ref.main()
    _, rows = _csv("ref.csv")
    want = [(int(r[0]), int(r[1])) for r in rows]
    n = 1 << aggregate_bench.ROWS_LOG2[small]
    assert want == [(n, 1 << e) for e in aggregate_bench.EXPONENTS[small]]
    assert sorted(set(caps)) == sorted(aggregate_bench.capacity(k)
                                       for _, k in want)
    ours = []
    monkeypatch.setattr(aggregate_bench.torch, "randint", lambda lo, hi,
                        shape, generator, **kw: ours.append(
                            (shape[0], hi, generator.initial_seed())))
    for n_, k, seed in draws:
        aggregate_bench.draw(n_, k, seed, "cpu")
    assert draws == [(n, 1 << 30, 1)] + [
        (n, 1 << e, e) for e in aggregate_bench.EXPONENTS[small]]
    assert ours == draws


def _tables(lrows, orows, crows, prows, nrows):
    t = types.SimpleNamespace
    return (t(num_tuples=lrows, shipdate=t(shape=(lrows,))),
            *(t(num_tuples=n) for n in (orows, crows, prows, nrows)))


def test_tpch_queries_and_rows_equal_the_reference(jax_driver, monkeypatch):
    """The queries, their order and the throughput's input rows: the JAX
    driver run on stand-in tables with a host clock that ticks 1e-6 s a
    read a rep, so a fused row's M rows/s is its input rows."""
    ref = jax_driver("tpch_bench")
    tables = _tables(6_001_215, 1_500_000, 150_000, 200_000, 25)
    seen = []

    def staged(name):
        def run(*args, algorithm):
            seen.append((name, "staged", len(args)))
            return types.SimpleNamespace(matches=1, timings=types.
                                         SimpleNamespace(mrows_per_s=1.0,
                                                         phases={}))
        return run

    def fused(name):
        def run(*args):
            seen.append((name, "fused", len(args)))
            return 1, True
        return run

    for q in tpch_bench.QUERIES:
        monkeypatch.setattr(ref, f"tpch_{q.lower()}", staged(q))
        monkeypatch.setattr(ref, f"tpch_{q.lower()}_fused", fused(q))
    monkeypatch.setattr(ref, "load_disk_tables", lambda scale: tables)
    reps = 3
    monkeypatch.setattr(ref, "time", types.SimpleNamespace(
        perf_counter=itertools.count(0, reps * 1e-6).__next__))
    ref.main(scale=1.0, reps=reps, csv_path="ref.csv")
    header, rows = _csv("ref.csv")
    assert header == tpch_bench.CSV_HEADER
    fused_rows = {r[0]: float(r[5]) for r in rows if r[2] == "fused"}
    assert list(fused_rows) == list(tpch_bench.QUERIES)
    want = tpch_bench.input_rows(*tables)
    assert {q: round(v) for q, v in fused_rows.items()} == want
    order = [q for q, plan, _ in seen if plan == "staged"]
    assert order == [q for q in tpch_bench.QUERIES for _ in range(reps + 1)]
    arity = {q: n for q, _, n in seen}
    assert arity == {q: len(a) for q, a in tpch_bench.plan_args(
        *tables).items()}


@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
def test_cracking_study_equals_the_reference(jax_driver, monkeypatch,
                                             small):
    """Sizes, seeds, depth, key bits, query count and the variants' names
    and order."""
    import aqp_tpu.joins.api
    import aqp_tpu.joins.crk

    ref = jax_driver("cracking")
    made, cracks, joins = [], [], []
    out = types.SimpleNamespace(matches=0)
    monkeypatch.setattr("aqp_tpu.data.create_relation_pk",
                        lambda n, seed: made.append(("pk", n, seed)) or
                        types.SimpleNamespace(key=None))
    monkeypatch.setattr("aqp_tpu.data.create_relation_fk",
                        lambda n, m, seed: made.append(("fk", n, m, seed))
                        or types.SimpleNamespace(key=None))
    monkeypatch.setattr(ref, "hard_sync", lambda x: x)
    monkeypatch.setattr(aqp_tpu.joins.crk, "crack_relation",
                        lambda rel, kb: cracks.append(kb))
    monkeypatch.setattr(aqp_tpu.joins.crk, "crk_join_cracked",
                        lambda r, s, cfg, depth: joins.append(depth) or
                        (out, r, s))
    monkeypatch.setattr(aqp_tpu.joins.api, "run_join",
                        lambda *a: (out, None))
    monkeypatch.setattr(sys, "argv", ["cracking.py"] + ["--small"] * small)
    ref.main()
    header, rows = _csv("results/cracking.csv")
    assert header == cracking.CSV_HEADER
    nr, ns = cracking.SIZES[small]
    assert made == [("pk", nr, cracking.SEEDS[0]),
                    ("fk", ns, nr, cracking.SEEDS[1])]
    from aqp_tpu_torch.config import JoinConfig
    depth, kb = cracking.crack_geometry(nr, JoinConfig())
    assert set(cracks) == {kb} and set(joins) == {depth}
    assert [(r[0], int(r[1])) for r in rows] == [
        (v, q) for v in cracking.VARIANTS for q in range(8)]


@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
def test_rho_phases_workload_equals_the_reference(jax_driver, monkeypatch,
                                                  small):
    """Sizes, seeds and the staged reps (the JAX driver on a CPU runs no
    fused rows)."""
    import aqp_tpu.joins.api

    ref = jax_driver("rho_phases")
    made, calls = [], []
    rel = types.SimpleNamespace(key=None, payload=None)
    monkeypatch.setattr(ref, "create_relation_pk", lambda n, seed: made.append(
        ("pk", n, seed)) or rel)
    monkeypatch.setattr(ref, "create_relation_fk",
                        lambda n, m, seed: made.append(("fk", n, m, seed))
                        or rel)
    monkeypatch.setattr(ref, "hard_sync", lambda x: x)
    monkeypatch.setattr(aqp_tpu.joins.api, "run_join", lambda *a: calls.append(
        a[2]) or (None, types.SimpleNamespace(phases={"total": 1.0})))
    ref.main(small=small)
    header, rows = _csv("results/rho-phases.csv")
    assert header == rho_phases.CSV_HEADER
    nr, ns = rho_phases.SIZES[small]
    assert made == [("pk", nr, rho_phases.SEEDS[0]),
                    ("fk", ns, nr, rho_phases.SEEDS[1])]
    assert calls == ["RHO"] * (1 + rho_phases.STAGED_REPS)
    assert ref.timeit.__kwdefaults__ == {"reps": rho_phases.FUSED_REPS}


def test_roofline_workload_equals_the_reference(jax_driver, monkeypatch):
    ref = jax_driver("roofline")
    made = []

    class Stop(Exception):
        pass

    def fk(n, m, seed):
        made.append(("fk", n, m, seed))
        raise Stop

    monkeypatch.setattr(ref, "create_relation_pk",
                        lambda n, seed: made.append(("pk", n, seed)))
    monkeypatch.setattr(ref, "create_relation_fk", fk)
    with pytest.raises(Stop):
        ref.main()
    nr, ns = roofline.SIZES[False]
    assert (ref.NR, ref.NS) == (nr, ns)
    assert made == [("pk", nr, roofline.SEEDS[0]),
                    ("fk", ns, nr, roofline.SEEDS[1])]
    assert ref.timeit.__defaults__ == (roofline.REPS,)


# ---------------------------------------------------------------------------
# The drivers end to end on the CPU, held to the JAX package


def test_rho_phases_small_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(rho_phases, "FUSED_REPS", 1)
    out = tmp_path / "rho.csv"
    rows = rho_phases.main(["--small", "--device", "cpu", "--csv",
                            str(out)])
    header, table = _csv(out)
    assert header == rho_phases.CSV_HEADER == _reference_header("rho_phases")
    assert len(table) == len(rows)
    staged = [r for r in rows if r[0] == "staged"]
    assert {r[2] for r in staged} == {0, 1, 2}
    assert {r[1] for r in staged} >= {"total"}
    assert [r[1] for r in rows if r[0] == "fused"] == [
        "pack", "partition_k1k2", "join_k3", "total"]
    ns = rho_phases.SIZES[True][1]
    assert {r[4] for r in rows if r[4] is not None} == {ns}
    assert all(float(r[3]) >= 0 for r in table)


def _expected_kernel_bytes(n, prm):
    from aqp_tpu_torch.ops.kernels.rho3 import num_blocks

    nb = num_blocks(n, prm)
    nbg = nb // prm.group
    k1_out = nb * prm.f1 * prm.cap1 + nb * prm.f1
    k2_out = prm.f1 * nbg * prm.f2 * (prm.cap2 + 1)
    return {"K1": 4 * (n + k1_out) + 8,
            "K2": 4 * (k1_out + k2_out) + 8,
            "K3": 4 * k2_out + 16}


def test_roofline_bytes_are_the_ports_tensors():
    """At a small Rho3Params: the bytes of K1's and K2's (and K3's) input
    and output tensors, from the geometry."""
    from aqp_tpu_torch.data import create_relation_fk, create_relation_pk
    from aqp_tpu_torch.ops.kernels.rho3 import Rho3Params

    prm = Rho3Params(**SMALL_GEOM)
    r = create_relation_pk(3000, device="cpu")
    s = create_relation_fk(12000, 3000, device="cpu")
    calls = roofline.kernel_inputs(r.key, s.key, prm)
    assert roofline.kernel_bytes(calls) == _expected_kernel_bytes(15000,
                                                                  prm)
    m, _ = calls["K3"][0]()
    assert int(m) == 12000


def test_roofline_small_on_the_cpu(tmp_path, monkeypatch):
    """At a small Rho3Params and 2^12 x 2^14 keys (2^16 x 2^18 with
    --small, cut for the suite's time)."""
    from aqp_tpu_torch.ops.kernels.rho3 import Rho3Params

    prm = Rho3Params(**SMALL_GEOM)
    monkeypatch.setattr(roofline, "REPS", 1)
    monkeypatch.setattr(roofline, "Rho3Params", lambda: prm)
    monkeypatch.setitem(roofline.SIZES, True, (1 << 12, 1 << 14))
    out = tmp_path / "roofline.md"
    got = roofline.main(["--small", "--device", "cpu", "--out", str(out)])
    text = out.read_text()
    assert text.splitlines() == got["lines"]
    cols = [c.strip() for c in roofline.TABLE_HEADER.strip("|").split("|")]
    ref = (ROOT / "experiments" / "roofline.py").read_text()
    for col in cols[:4]:
        assert f"{col} |" in ref
    assert cols[4] == "% of 3350 GB/s peak"
    assert "819 GB/s" not in text and "v5e" not in text
    assert "VPU" not in text
    assert "data sheet" in text
    nr, ns = roofline.SIZES[True]
    assert got["matches"] == ns
    want = _expected_kernel_bytes(nr + ns, prm)
    assert {k: g for k, (g, _) in got["kernels"].items()} == {
        k: v / 1e9 for k, v in want.items()}
    assert got["stages"]["K1+K2 (partition)"][0] == (want["K1"]
                                                     + want["K2"]) / 1e9


def _scan_reference_outputs(ref_mod, n, sel):
    col = ref_mod.make_col(n)
    fns = ref_mod.make_fns(col, n, "xla", n // 128, *ref_mod.dict_planes())
    lo, hi = ref_mod.sel_bounds(sel)
    out = {}
    for m, (fn, _, _) in fns.items():
        got = fn(lo, hi)
        out[m] = [np.asarray(x) for x in (got if isinstance(got, tuple)
                                          else (got,))]
    return out


def _live(mode, engine, out, n):
    """The qualifying rows of a write mode as (row ids, columns), sorted by
    row id."""
    out = [np.asarray(x) for x in out]
    if engine == "pallas":
        ids = out[0]
        keep = ids < n
        cols = [c[keep] for c in out[1:1 + {"index": 0, "values": 1,
                                             "dict": 2}[mode]]]
        ids = ids[keep]
    else:
        cnt = int(out[-1])
        ids = None
        cols = [c[:cnt] for c in out[:-1]]
    return ids, cols


@pytest.mark.parametrize("sel", [10.0, 50.0])
def test_scan_fns_equal_the_reference_xla_engine(jax_driver, sel):
    """make_fns on make_col(2^20), both of the port's engines, against the
    JAX driver's xla engine: count, sum and the bitvector equal; the write
    modes' qualifying rows (ids, values, dictionary planes) equal."""
    ref = jax_driver("scan_bench")
    n = 1 << 20
    want = _scan_reference_outputs(ref, n, sel)
    col = scan_bench.make_col(n, "cpu")
    dlo, dhi = scan_bench.dict_planes("cpu")
    lo, hi = scan_bench.sel_bounds(sel)
    assert (lo, hi) == tuple(int(x) for x in ref.sel_bounds(sel))
    ref_ids = np.flatnonzero(np.asarray(ref.make_col(n)) <= hi)
    for engine in scan_bench.ENGINES:
        fns = scan_bench.make_fns(col, n, engine, n // 128, dlo, dhi, "cpu")
        for mode in scan_bench.MODES:
            out = fns[mode][0](lo, hi)
            if mode in ("count", "sum", "bitvector"):
                got = out.numpy() if mode == "bitvector" else int(out)
                w = want[mode][0]
                assert np.array_equal(got, w), (engine, mode)
                continue
            assert fns[mode][1](out) == ref_ids.size, (engine, mode)
            ids, cols = _live(mode, engine, out, n)
            _, wcols = _live(mode, "xla", want[mode], n)
            if ids is not None:
                np.testing.assert_array_equal(np.sort(ids), ref_ids)
                order = np.argsort(ids)
                cols = [c[order] for c in cols]
                if mode == "index":
                    continue
            for g, w in zip(cols, wcols):
                np.testing.assert_array_equal(g.astype(np.int64),
                                              w.astype(np.int64),
                                              err_msg=f"{engine} {mode}")


def test_scan_bench_small_on_the_cpu(tmp_path, monkeypatch):
    """--small with its columns cut to 2^18 rows (the scale-up family keeps
    2^17, below one of B7's blocks) for the suite's time."""
    monkeypatch.setitem(scan_bench.SELECTIVITY_ROWS, True,
                        {m: 1 << 18 for m in scan_bench.MODES})
    monkeypatch.setitem(scan_bench.SCALEUP_ROWS, True, (1 << 17, 1 << 18))
    monkeypatch.setitem(scan_bench.RESIDENCY_ROWS, True, 1 << 18)
    rows = scan_bench.main(["--small", "--device", "cpu", "--reps", "1",
                            "--csv-dir", str(tmp_path)])
    for fam, (_, name) in scan_bench.FAMILIES.items():
        header, table = _csv(tmp_path / name)
        assert header == scan_bench.CSV_HEADER == _reference_header(
            "scan_bench")
        assert [r[:6] for r in table] == [list(map(str, r[:6]))
                                          for r in rows[fam]]
    for r in itertools.chain(*rows.values()):
        fam, mode, engine, n, sel, res, ms = r[:7]
        hi = scan_bench.sel_bounds(sel)[1]
        qualifying = n // 256 * (hi + 1)
        want = {"count": qualifying, "sum": n // 256 * hi * (hi + 1) // 2,
                "bitvector": sum(1 << i for i in range(8) if i <= hi)}
        assert r[9] == want.get(mode, qualifying), r
        assert ms > 0


def test_aggregate_bench_small_on_the_cpu(tmp_path, monkeypatch):
    """At 2^16 rows (2^20 with --small) and the routed engine at a small
    Rho3Params, cut for the suite's time: every
    row's live groups equal the JAX package's groupby_aggregate on the same
    keys and payloads, within the capacity."""
    import jax.numpy as jnp

    from aqp_tpu.ops.aggregate import groupby_aggregate

    import functools

    from aqp_tpu_torch.ops.kernels import aggpipe
    from aqp_tpu_torch.ops.kernels.rho3 import Rho3Params

    monkeypatch.setitem(aggregate_bench.ROWS_LOG2, True, 16)
    monkeypatch.setattr(aggregate_bench, "groupby_aggregate_routed_auto",
                        functools.partial(
                            aggpipe.groupby_aggregate_routed_auto,
                            prm=Rho3Params(**SMALL_GEOM)))
    out = tmp_path / "agg.csv"
    rows = aggregate_bench.main(["--small", "--device", "cpu", "--reps",
                                 "1", "--csv", str(out)])
    header, table = _csv(out)
    assert header == aggregate_bench.CSV_HEADER == _reference_header(
        "aggregate_bench")
    assert [int(r[1]) for r in table] == [
        1 << e for e in aggregate_bench.EXPONENTS[True]]
    n = 1 << 16
    pay = aggregate_bench.draw(n, 1 << 30, 1, "cpu").numpy()
    for (rows_, k, live, eng, ms, _), e in zip(
            rows, aggregate_bench.EXPONENTS[True]):
        key = aggregate_bench.draw(n, k, e, "cpu").numpy()
        cap = aggregate_bench.capacity(k)
        want = int(groupby_aggregate(jnp.asarray(key), jnp.asarray(pay),
                                     cap).num_groups)
        assert (rows_, live, eng) == (n, want, "routed") and live <= cap


def test_tpch_bench_small_on_the_cpu(tmp_path):
    """The driver on its dbgen store at SF 0.002, the staged plans' joins
    by PSM (the suite's time: RHO's staged ladder on the dbgen store is
    tests/test_torch_tpch_store.py's): each query's staged and fused
    matches equal the JAX package's fused plan on the same store, loaded
    by the JAX loaders (its staged plans equal its fused ones:
    tests/test_tpch_fused.py)."""
    from aqp_tpu.data import tpch_loader as jloader
    from aqp_tpu.queries.fused import (tpch_q3_fused, tpch_q10_fused,
                                       tpch_q12_fused, tpch_q19_fused)

    out = tmp_path / "tpch.csv"
    rows = tpch_bench.main(["--small", "--scale", str(TPCH_SCALE), "--reps",
                            "1", "--algorithm", "PSM", "--store",
                            str(tmp_path / "data"), "--device", "cpu",
                            "--csv", str(out)])
    header, table = _csv(out)
    assert header == tpch_bench.CSV_HEADER == _reference_header(
        "tpch_bench")
    assert len(table) == len(rows) == 8
    base = tmp_path / "data" / f"scale{TPCH_SCALE}"
    l, o, c, p, n = (getattr(jloader, f"load_{t}")(str(base)) for t in (
        "lineitem", "orders", "customer", "part", "nation"))
    args = tpch_bench.plan_args(l, o, c, p, n)
    plans = {"Q3": tpch_q3_fused, "Q10": tpch_q10_fused,
             "Q12": tpch_q12_fused, "Q19": tpch_q19_fused}
    for q, plan in plans.items():
        m, ok = plan(*args[q])
        want = int(m)
        assert bool(ok) and want > 0, q
        got = {r[2]: r[6] for r in rows if r[0] == q}
        assert got == {"staged": want, "fused": want}, q
    assert {r[-1] for r in rows} == {"disk"}
    assert {r[3] for r in rows} == {"PSM", "RHO"}   # fused rows: RHO


def test_cracking_small_on_the_cpu(tmp_path):
    """Every query of the three variants matches what the JAX package's
    crk_join_cracked finds on the same relations."""
    import jax.numpy as jnp

    from aqp_tpu.config import JoinConfig as JConfig
    from aqp_tpu.joins.crk import crack_relation, crk_join_cracked
    from aqp_tpu.relation import Relation as JRelation
    from aqp_tpu_torch.config import JoinConfig
    from aqp_tpu_torch.data import create_relation_fk, create_relation_pk

    out = tmp_path / "crack.csv"
    rows = cracking.main(["--small", "--queries", "2", "--device", "cpu",
                          "--csv", str(out)])
    header, table = _csv(out)
    assert header == cracking.CSV_HEADER == _reference_header("cracking")
    assert [(r[0], int(r[1])) for r in table] == [
        (v, q) for v in cracking.VARIANTS for q in range(2)]
    nr, ns = cracking.SIZES[True]
    rels = [create_relation_pk(nr, seed=cracking.SEEDS[0], device="cpu"),
            create_relation_fk(ns, nr, seed=cracking.SEEDS[1],
                               device="cpu")]
    depth, kb = cracking.crack_geometry(nr, JoinConfig())
    jr, js = (crack_relation(JRelation(jnp.asarray(r.key.numpy()),
                                       jnp.asarray(r.payload.numpy())), kb)
              for r in rels)
    want = int(crk_join_cracked(jr, js, JConfig(), depth)[0].matches)
    assert want == ns
    assert {r[4] for r in rows} == {want}


def test_drivers_without_a_card_raise():
    """`python -m` of each driver, no card and no --device cpu: a non-zero
    exit that names the missing device, nothing run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"aqp_tpu_torch.experiments.{name}",
         "--small"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in DRIVERS]
    for name, proc in zip(DRIVERS, procs):
        _, err = proc.communicate(timeout=240)
        assert proc.returncode != 0, name
        assert "no CUDA device" in err, (name, err[-500:])

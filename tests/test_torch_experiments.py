"""The port's drivers (aqp_tpu_torch/experiments/) run end to end on the
CPU with --small, every leg through the kernels' plain versions, and write
CSVs under the JAX package's drivers' headers: the two microbenchmarks,
and the four join sweeps, whose full-size matrices equal the JAX package's
drivers' field by field."""

import csv
import itertools
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from aqp_tpu_torch.experiments import membench, partition_bench

ROOT = Path(__file__).resolve().parents[1]

PARTITION_PHASES = ["histogram (bincount)"] * 4 + [
    "partition pass (stable sort)"] * 2 + ["sort+hist (K-A)",
                                          "seg scatter (K-B)"]
MEM_BENCHMARKS = ["stream add (r+w)", "cumsum", "gather (perm)",
                  "scatter (unique)", "sort i32", "sort pair i32",
                  "block sort"]


def _read(path):
    with open(path) as f:
        return list(csv.reader(f))


def _reference_header(name):
    """The CSV header the JAX package's driver writes."""
    text = (ROOT / "experiments" / f"{name}.py").read_text()
    for line in text.splitlines():
        if 'f.write("' in line and "\\n" in line:
            return line.split('f.write("')[1].split("\\n")[0]
    raise AssertionError(f"no CSV header in experiments/{name}.py")


def test_partition_bench_small_on_the_cpu(tmp_path):
    out = tmp_path / "partition.csv"
    rows = partition_bench.main(["--small", "--device", "cpu", "--sub",
                                 "128", "--csv", str(out)])
    table = _read(out)
    assert ",".join(table[0]) == partition_bench.CSV_HEADER == \
        _reference_header("partition_bench")
    assert [r[0] for r in table[1:]] == PARTITION_PHASES
    assert [int(r[2]) for r in table[1:]] == [4, 8, 12, 16, 4, 8, 4, 4]
    assert all(int(r[1]) == 1 << 21 for r in table[1:])
    assert all(r[3] > 0 and r[4] > 0 for r in rows)


def test_membench_small_on_the_cpu(tmp_path):
    out = tmp_path / "mem.csv"
    rows = membench.main(["--small", "--device", "cpu", "--csv", str(out)])
    table = _read(out)
    assert ",".join(table[0]) == membench.CSV_HEADER == \
        _reference_header("membench")
    assert [r[0] for r in table[1:]] == MEM_BENCHMARKS
    assert all(int(r[1]) == 1 << 20 for r in table[1:])
    assert all(r[2] > 0 and r[4] > 0 for r in rows)


def test_drivers_run_as_modules():
    """`python -m ...` reaches main(); without a card the default device
    raises (no silent fall back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    for mod in ("partition_bench", "membench"):
        out = subprocess.run(
            [sys.executable, "-m", f"aqp_tpu_torch.experiments.{mod}",
             "--small"], cwd=ROOT, capture_output=True, text=True,
            timeout=120)
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr


def test_wrapper_split_calls_on_small_inputs_and_needs_a_card(monkeypatch):
    """wrapper_split's four calls run (here their plain versions, on
    scaled-down relations) and give the wrappers' outputs; without a card
    its main exits 2 and measures nothing."""
    from aqp_tpu_torch.experiments import wrapper_split as ws

    monkeypatch.setattr(ws, "NR", 1 << 14)
    monkeypatch.setattr(ws, "NS", 1 << 16)
    for name in ("create_relation_pk", "create_relation_zipf"):
        make = getattr(ws, name)
        monkeypatch.setattr(ws, name, lambda *a, make=make, **k: make(
            *a, **{**k, "device": "cpu"}))
    got = ws.calls()
    assert list(got) == ["RSTATS keys-only", "RSTATS with payloads",
                         "scatter_segments", "scatter_segments_one"]
    assert tuple(got) == ws.LABELS
    cnt, pay = got["RSTATS with payloads"]()
    assert cnt.shape == pay.shape == (64,) and int(cnt.sum()) > 0
    assert not got["RSTATS keys-only"]()[1].any()
    ok, op = got["scatter_segments"]()
    assert ok.shape == op.shape and ok.shape[1] == 128
    assert torch.equal(got["scatter_segments_one"](), ok)
    if not torch.cuda.is_available():
        assert ws.main([]) == 2


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_exact_core_calls_on_small_inputs_and_needs_a_card(monkeypatch,
                                                            dtype):
    """exact_core's six calls give |S| matches on FK relations, one
    checksum wherever payloads count, and the same rows from both
    materialized forms; without a card its main exits 2."""
    from aqp_tpu_torch.data import create_relation_fk, create_relation_pk
    from aqp_tpu_torch.experiments import exact_core

    r = create_relation_pk(1 << 12, dtype=dtype, random_payload=True,
                           device="cpu")
    s = create_relation_fk(1 << 14, 1 << 12, dtype=dtype,
                           random_payload=True, device="cpu")
    got = {k: fn() for k, fn in exact_core.calls(r, s).items()}
    assert len(got) == 6
    assert {int(v.matches) for v in got.values()} == {1 << 14}
    assert len({int(v.checksum) for k, v in got.items()
                if "keys" not in k}) == 1
    a, b = got["merge_join_materialize"], got["PSM materialize"]
    assert a.key.dtype == b.key.dtype == dtype
    assert all(torch.equal(x, y) for x, y in zip(
        (a.key, a.r_payload, a.s_payload), (b.key, b.r_payload, b.s_payload)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert exact_core.main([]) == 2


# ---------------------------------------------------------------------------
# The join-sweep drivers: join_overview (and its key64 rows), skew,
# selectivity and scaling

SWEEPS = ("join_overview", "skew", "selectivity", "scaling")


def _port_configs(name, small=False):
    """The port driver's matrices (ExperimentConfig list) and backend."""
    import importlib

    mod = importlib.import_module(f"aqp_tpu_torch.experiments.{name}")
    if name == "join_overview":
        return mod.configs(small)
    return [mod.config(small)]


@pytest.fixture
def reference_driver(monkeypatch):
    """Call a JAX package driver's main with run_experiments_pipelined and
    rows_to_csv replaced by recorders: nothing runs and nothing is
    written.  Returns [(config, backend)] and the CSV writes."""
    import importlib

    import jax

    import aqp_tpu.utils

    monkeypatch.setattr(aqp_tpu.utils, "ensure_platform_from_env",
                        lambda: None)
    x64 = jax.config.jax_enable_x64

    def call(name, fn="main", **kw):
        mod = importlib.import_module(f"experiments.{name}")
        seen, written = [], []

        def record(cfg, backend=None):
            seen.append((cfg, backend))
            return []

        monkeypatch.setattr(mod, "run_experiments_pipelined", record)
        monkeypatch.setattr(mod, "rows_to_csv",
                            lambda rows, path, append=False:
                            written.append((path, append)))
        try:
            getattr(mod, fn)(**kw)
        finally:   # main_key64 turns jax_enable_x64 on
            jax.config.update("jax_enable_x64", x64)
        return seen, written

    return call


def _fields(cfg):
    """An ExperimentConfig's fields as plain values, the port's device
    aside."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(cfg):
        if f.name != "device":
            v = getattr(cfg, f.name)
            out[f.name] = list(v) if isinstance(v, (list, tuple)) else v
    return out


@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_configs_equal_the_reference_drivers(reference_driver, name,
                                                   small):
    seen, written = reference_driver(name, small=small)
    want = [_fields(cfg) for cfg, backend in seen]
    assert [backend for _, backend in seen] == [None] * len(seen)
    assert [_fields(c) for c in _port_configs(name, small)] == want
    assert all(c.device == "cuda" for c in _port_configs(name, small))
    # the reference writes its results/*.csv; the port only where told
    assert written and all(p.startswith("results/") for p, _ in written)


@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
def test_key64_overview_config_equals_the_references(reference_driver,
                                                     small):
    from aqp_tpu_torch.experiments import join_overview

    seen, written = reference_driver("join_overview", "main_key64",
                                     small=small)
    assert [b for _, b in seen] == ["tpu_k64"]
    assert [_fields(c) for c in join_overview.key64_configs(small)] == [
        _fields(c) for c, _ in seen]
    assert written == [("results/join-overview.csv", True)]


def _expected_rows(cfgs):
    rows = set()
    for cfg in cfgs:
        reps = cfg.reps
        for alg, (nr, ns), skew, sel, mat in itertools.product(
                cfg.algorithms, cfg.sizes, cfg.skews, cfg.selectivities,
                cfg.materialize):
            for rep in range(reps):
                for m in ("phase_join_s", "phase_total_s", "matches",
                          "throughput_mrows"):
                    rows.add((alg, str(int(mat)), str(nr), str(ns),
                              str(skew if skew is not None else 0.0),
                              str(sel if sel is not None else 100.0),
                              str(rep), m))
    return rows


def _scaled_down(make):
    """A config function whose matrices have every size / 16 (the CPU
    serves the drivers' --small matrices in seconds alone, minutes on a
    loaded worker)."""
    import dataclasses

    def scaled(*a, **k):
        out = make(*a, **k)
        cfgs = out if isinstance(out, list) else [out]
        cfgs = [dataclasses.replace(c, sizes=[(r // 16, s // 16)
                                               for r, s in c.sizes])
                for c in cfgs]
        return cfgs if isinstance(out, list) else cfgs[0]

    return scaled


@pytest.mark.parametrize("name", SWEEPS + ("join_overview --key64",))
def test_sweep_small_on_the_cpu(tmp_path, monkeypatch, name):
    """The driver end to end on the CPU at --small, its sizes cut to 1/16:
    the reference's CSV header, every (alg, size, skew, selectivity, rep,
    measurement) row of its matrices and no error row; FK workloads count
    |S|."""
    import importlib

    from aqp_tpu.harness.runner import CSV_HEADER as REF_HEADER

    mod_name, *flags = name.split()
    mod = importlib.import_module(f"aqp_tpu_torch.experiments.{mod_name}")
    for fn in ("config", "configs", "key64_configs"):
        if hasattr(mod, fn):
            monkeypatch.setattr(mod, fn, _scaled_down(getattr(mod, fn)))
    out = tmp_path / "sweep.csv"
    if flags:
        out.write_text(REF_HEADER + "\n")   # --key64 appends
    rows = mod.main(["--small", "--device", "cpu", "--csv", str(out),
                     *flags])
    table = _read(out)
    assert ",".join(table[0]) == REF_HEADER
    assert len(table) == 1 + len(rows)
    cfgs = (mod.key64_configs(True) if flags else _port_configs(mod_name,
                                                                 True))
    got = {tuple(r[1:9]) for r in table[1:]}
    assert got == _expected_rows(cfgs)
    assert {r[0] for r in table[1:]} == {"cpu_k64" if flags else "cpu"}
    for r in table[1:]:
        if r[8] == "matches" and r[5] == "0.0" and r[6] == "100.0":
            assert float(r[9]) == float(r[4])


def test_sweeps_write_nothing_by_default(monkeypatch):
    """Without --csv no driver writes (the JAX package's results/*.csv
    stay as they are); nothing runs here, the runner is replaced."""
    import importlib

    from aqp_tpu_torch.experiments import sweep

    written = []
    monkeypatch.setattr(sweep, "run_experiments_pipelined",
                        lambda cfg, backend=None: [])
    monkeypatch.setattr(sweep, "rows_to_csv",
                        lambda *a, **k: written.append(a))
    for name in SWEEPS:
        mod = importlib.import_module(f"aqp_tpu_torch.experiments.{name}")
        assert mod.main(["--device", "cpu"]) == []
    assert written == []

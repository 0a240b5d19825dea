"""The port's experiment harness and logger against the JAX package's, on
the CPU: ExperimentConfig's fields, defaults and order, the measurement
rows of both runners, the error rows, the CSV writer's bytes, key64's
int64 workloads and rows, and the log line format."""

import dataclasses
import logging
import re

import pytest

from aqp_tpu.harness import runner as jrunner
from aqp_tpu.utils import logging as jlogging
from aqp_tpu_torch.harness import runner
from aqp_tpu_torch.utils import logging as plogging

NR, NS = 4096, 16384


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_config_fields_and_defaults_equal_the_references():
    assert _fields(runner.ExperimentConfig) == (
        _fields(jrunner.ExperimentConfig) + [("device", "cuda")])
    assert runner.ExperimentConfig().checksum is False
    assert runner.ExperimentConfig().warmup is True
    kw = dict(algorithms=("RHO", "PSM"), sizes=((4, 16), (8, 32)),
              skews=(None, 1.5), selectivities=(None, 50.0),
              materialize=(False, True), reps=2)
    assert (list(runner.ExperimentConfig(**kw).enumerate())
            == list(jrunner.ExperimentConfig(**kw).enumerate()))
    assert runner.CSV_HEADER == jrunner.CSV_HEADER


def _rows(fn, mod, **kw):
    cfg = mod.ExperimentConfig(algorithms=("RHO", "PSM", "NOPE"),
                               sizes=((NR, NS),), materialize=(False, True),
                               reps=2, **kw)
    return fn(cfg)


def _names(rows):
    return [(r["alg"], r["materialize"], r["rep"], r["measurement"])
            for r in rows]


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
def test_runners_give_the_references_rows(pipelined):
    name = "run_experiments_pipelined" if pipelined else "run_experiments"
    want = _rows(getattr(jrunner, name), jrunner)
    got = _rows(getattr(runner, name), runner, device="cpu")
    assert _names(got) == _names(want)
    for g, w in zip(got, want):
        assert g["backend"] == "cpu"
        for k in ("size_r", "size_s", "skew", "selectivity"):
            assert g[k] == w[k], k
        if g["measurement"] in ("matches", "error"):
            assert g["value"] == w["value"]
    assert {r["value"] for r in got if r["measurement"] == "matches"} == {
        float(NS)}
    # the unknown algorithm: one error row a rep (one a config pipelined)
    errors = [r for r in got if r["measurement"] == "error"]
    assert {r["alg"] for r in errors} == {"NOPE"}
    assert len(errors) == (2 if pipelined else 4)


def test_rows_to_csv_writes_the_references_bytes(tmp_path):
    rows = [runner._row("cpu", "RHO", True, NR, NS, None, None, 0,
                        "matches", 16384.0),
            runner._row("cuda", "PHT", False, NR, NS, 1.5, 50.0, 2,
                        "phase_total_s", 0.0012345678901234),
            {**runner._row("cpu", "PSM", 0, 1, 2, 0.0, 100.0, 1,
                           "throughput_mrows", float("inf"))}]
    assert rows[0] == jrunner._row("cpu", "RHO", True, NR, NS, None, None,
                                   0, "matches", 16384.0)
    for append in (False, True):
        for mod, name in ((runner, "port.csv"), (jrunner, "ref.csv")):
            mod.rows_to_csv(rows, str(tmp_path / name), append=append)
        assert ((tmp_path / "port.csv").read_bytes()
                == (tmp_path / "ref.csv").read_bytes())
    text = (tmp_path / "port.csv").read_text()
    assert text.count(runner.CSV_HEADER) == 1
    assert len(text.splitlines()) == 1 + 2 * len(rows)


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
def test_key64_runs_int64_workloads(monkeypatch, pipelined):
    """key64 draws pk and fk as int64 and casts zipf and fk_sel to it (the
    reference's _gen_workload); every join runs under JoinConfig(key64=
    True) and the FK rows count |S|."""
    import torch

    made, cfgs = [], []
    gen, run = runner._gen_workload, runner.run_join

    def gen_spy(*a, **k):
        relR, relS = gen(*a, **k)
        made.append((relR.key.dtype, relS.key.dtype, relS.payload.dtype))
        return relR, relS

    def run_spy(relR, relS, alg, cfg, device):
        cfgs.append(cfg.key64)
        return run(relR, relS, alg, cfg, device=device)

    monkeypatch.setattr(runner, "_gen_workload", gen_spy)
    monkeypatch.setattr(runner, "run_join", run_spy)
    fn = (runner.run_experiments_pipelined if pipelined
          else runner.run_experiments)
    cfg = runner.ExperimentConfig(algorithms=("RHO", "PHT", "MWAY", "INL"),
                                  sizes=((NR, NS),), skews=(None, 1.5),
                                  reps=1, key64=True, device="cpu")
    rows = fn(cfg)
    # one workload resident at a time: drawn anew for each (alg, skew)
    assert made == [(torch.int64,) * 3] * 8
    assert cfgs and all(cfgs)
    assert not [r for r in rows if r["measurement"] == "error"]
    # Zipf draws from R's own key alphabet {1..|R|}: every row matches
    got = {(x["alg"], x["skew"]): x["value"] for x in rows
           if x["measurement"] == "matches"}
    assert got == {(a, z): float(NS) for a in cfg.algorithms
                   for z in (0.0, 1.5)}


def test_logger_line_format_matches_the_references():
    record = logging.LogRecord("x", logging.WARNING, __file__, 1,
                               "overflow %d", (3,), None)
    got = plogging._RelativeFormatter().format(record)
    want = jlogging._RelativeFormatter().format(record)
    stamp = re.compile(r"^\[ *\d+\.\d{6}\] ")
    assert stamp.match(got) and stamp.match(want)
    assert stamp.sub("", got) == stamp.sub("", want) == "WARNING overflow 3"
    log = plogging.get_logger("aqp_tpu_torch.test")
    assert log is plogging.get_logger("aqp_tpu_torch.test")
    assert len(log.handlers) == 1 and not log.propagate

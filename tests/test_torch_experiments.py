"""The port's two microbenchmark drivers (aqp_tpu_torch/experiments/) run
end to end on the CPU with --small, every leg through the kernels' plain
versions, and write CSVs under the JAX package's drivers' headers."""

import csv
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

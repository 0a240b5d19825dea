"""The port's command line (`python -m aqp_tpu_torch`) against the JAX
package's (`python -m aqp_tpu`), both run in-process on the CPU.

The port runs with `--device cpu`.  The reference's `main` is called with
`ensure_platform_from_env` replaced by a no-op, so that it leaves this
process's JAX configuration as the test configuration made it.  Both
packages draw their relations from their own generators, so a count is
compared across packages only where it is a closed form (FK: |S|) or
where both read the same bytes (the dbgen store); the Zipf and
selectivity workloads are held to the port's exact core on the port's
own relations.
"""

import json
import os

import pytest
import torch

import aqp_tpu.__main__ as jmain
import aqp_tpu.utils
from aqp_tpu.data import tpch_dbgen as jdbgen
from aqp_tpu_torch import __main__ as pmain
from aqp_tpu_torch.data import (create_relation_fk_sel, create_relation_pk,
                                create_relation_zipf)
from aqp_tpu_torch.harness.runner import CSV_HEADER
from aqp_tpu_torch.ops import mergejoin

NR, NS = 4096, 16384


@pytest.fixture
def ref_cli(monkeypatch, capsys):
    monkeypatch.setattr(aqp_tpu.utils, "ensure_platform_from_env",
                        lambda: None)
    monkeypatch.setenv("LIBTPU_INIT_ARGS", os.environ.get(
        "LIBTPU_INIT_ARGS", "--xla_tpu_scoped_vmem_limit_kib=100000"))

    def run(argv):
        capsys.readouterr()
        jmain.main(argv)
        return capsys.readouterr().out

    return run


@pytest.fixture
def port_cli(capsys):
    def run(argv):
        capsys.readouterr()
        pmain.main(argv + ["--device", "cpu"])
        return capsys.readouterr().out

    return run


def _tuples(out: str) -> int:
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith("Result tuples: ")]
    return int(line.split(": ")[1])


def _json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("materialize", [False, True], ids=["count", "m"])
@pytest.mark.parametrize("alg", ["RHO", "PHT", "PSM"])
def test_join_equals_reference(ref_cli, port_cli, alg, materialize):
    argv = ["join", "-a", alg, "-r", str(NR), "-s", str(NS), "--reps", "1",
            "--quiet"] + (["-m"] if materialize else [])
    want, got = ref_cli(argv), port_cli(argv)
    assert _tuples(got) == _tuples(want) == NS
    jw, jg = _json(want), _json(got)
    assert sorted(jg) == sorted(jw)
    for k in ("matches", "rows_in", "alg", "size_r", "size_s"):
        assert jg[k] == jw[k], k
    assert "total" in jg["phases"]
    # the contract's lines: a phase line each, then tuples and throughput
    assert got.splitlines()[-2].startswith("Throughput (M rec/sec): ")


@pytest.mark.parametrize("flag", [["-z", "1.5"], ["-l", "50"]],
                         ids=["zipf", "selectivity"])
def test_join_skew_and_selectivity_equal_the_exact_core(port_cli, flag):
    out = port_cli(["join", "-r", str(NR), "-s", str(NS), "--reps", "1",
                    "--quiet", *flag])
    r = create_relation_pk(NR, seed=11111, device="cpu")
    if flag[0] == "-z":
        s = create_relation_zipf(NS, NR, 1.5, seed=22222, device="cpu")
    else:
        s = create_relation_fk_sel(NS, NR, 50.0, seed=22222, device="cpu")
    want = int(mergejoin.merge_join_count(r.key, r.payload, s.key,
                                          s.payload).matches)
    assert _tuples(out) == _json(out)["matches"] == want
    if flag[0] == "-l":
        assert 0 < want < NS


def test_predefined_datasets_map_to_the_references_sizes(port_cli,
                                                         monkeypatch):
    for name in ("cache-fit", "cache-exceed", "L"):
        assert pmain._dataset_sizes(name) == jmain._dataset_sizes(name)
    assert pmain._dataset_sizes("cache-exceed") == (13_107_200, 52_428_800)
    for mod in (pmain, jmain):
        with pytest.raises(SystemExit, match="unknown dataset"):
            mod._dataset_sizes("XL")
    # -x reaches the join: run it at a size the CPU serves quickly
    seen = []

    def small(name):
        seen.append(name)
        return NR, NS

    monkeypatch.setattr(pmain, "_dataset_sizes", small)
    out = port_cli(["join", "-x", "cache-fit", "--reps", "1", "--quiet"])
    assert seen == ["cache-fit"]
    assert (_json(out)["size_r"], _json(out)["size_s"]) == (NR, NS)
    assert _tuples(out) == NS


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A dbgen store at SF 0.005 (both packages write the same bytes)."""
    base = tmp_path_factory.mktemp("dbgen")
    jdbgen.generate(0.005, base)
    return str(base)


@pytest.mark.parametrize("fused", [False, True], ids=["staged", "fused"])
@pytest.mark.parametrize("q", [3, 10, 12, 19])
def test_tpch_equals_reference(ref_cli, port_cli, store, q, fused):
    argv = ["tpch", "-q", str(q), "--data", store, "--reps", "1"] + (
        ["--fused"] if fused else [])
    want, got = ref_cli(argv), port_cli(argv)
    assert _tuples(got) == _tuples(want)
    jw, jg = _json(want), _json(got)
    assert sorted(jg) == sorted(jw)
    for k in ("matches", "rows_in", "query", "alg", "scale"):
        assert jg[k] == jw[k], k


@pytest.mark.parametrize("mode", ["count", "sum", "bitvector", "index",
                                  "values", "dict"])
def test_scan_equals_reference(ref_cli, port_cli, mode):
    argv = ["scan", "--mode", mode, "--rows", "65536", "--selectivity",
            "10", "--reps", "1"]
    jw, jg = _json(ref_cli(argv)), _json(port_cli(argv))
    assert sorted(jg) == sorted(jw)
    for k in ("mode", "rows", "selectivity"):
        assert jg[k] == jw[k], k
    assert jg["seconds"] > 0


def _csv(path):
    lines = path.read_text().splitlines()
    return lines[0], [ln.split(",") for ln in lines[1:]]


def test_matrix_equals_reference(ref_cli, port_cli, tmp_path):
    argv = ["matrix", "--algs", "RHO,PHT,PSM", "--sizes", f"{NR}x{NS}",
            "--materialize", "both", "--reps", "1", "--csv"]
    ref_cli(argv + [str(tmp_path / "ref.csv")])
    port_cli(argv + [str(tmp_path / "port.csv")])
    hw, want = _csv(tmp_path / "ref.csv")
    hg, got = _csv(tmp_path / "port.csv")
    assert hg == hw == CSV_HEADER
    assert {r[0] for r in got} == {"cpu"}
    assert not [r for r in got if r[8] == "error"]

    def rows(table, alg):
        # PHT's phases name its route: the reference's CPU route is its
        # staged engine (build, probe), the port's the kernel pipeline on
        # every device (join); the measured quantities are the same
        return [(r[1], r[2], r[8]) for r in table if r[1] == alg and (
            alg != "PHT" or not r[8].startswith("phase_")
            or r[8] == "phase_total_s")]

    for alg in ("RHO", "PHT", "PSM"):
        assert rows(got, alg) == rows(want, alg), alg
    assert [r[1:8] + [r[9]] for r in got if r[8] == "matches"] == [
        r[1:8] + [r[9]] for r in want if r[8] == "matches"]
    assert {float(r[9]) for r in got if r[8] == "matches"} == {float(NS)}


def test_profile_adds_the_trace(port_cli, tmp_path):
    out = port_cli(["join", "-r", str(NR), "-s", str(NS), "--reps", "1",
                    "--quiet", "--profile", str(tmp_path / "p")])
    j = _json(out)
    assert j["profile_dir"] == str(tmp_path / "p")
    assert j["device_total_s"] == 0.0          # the CPU: no device event
    assert list((tmp_path / "p").glob("*.trace.json"))
    port_cli(["matrix", "--algs", "RHO", "--sizes", f"{NR}x{NS}", "--reps",
              "1", "--profile", str(tmp_path / "m"), "--csv",
              str(tmp_path / "m.csv")])
    _, rows = _csv(tmp_path / "m.csv")
    assert [r[9] for r in rows if r[8] == "device_total_s"] == ["0.0"]
    assert list((tmp_path / "m").glob("*/*.trace.json"))


@pytest.mark.parametrize("flags", [["-a", "RHO"], ["-a", "PHT"],
                                   ["-a", "MWAY", "-m"], ["-a", "INL"],
                                   ["-a", "RHO", "-z", "1.5"]],
                         ids=["RHO", "PHT", "MWAY-m", "INL", "RHO-zipf"])
def test_key64_join_draws_int64_and_serves_them(port_cli, monkeypatch,
                                                flags):
    """join --key64 draws R and S as int64 and runs under
    JoinConfig(key64=True); FK gives matches == |S|, Zipf the exact
    core's count on the same int64 relations."""
    from aqp_tpu_torch.joins import api

    seen = []

    def spy(relR, relS, alg, cfg, device):
        seen.append((relR.key.dtype, relS.key.dtype, relR.payload.dtype,
                     cfg.key64))
        return real(relR, relS, alg, cfg, device=device)

    real = api.run_join
    monkeypatch.setattr(api, "run_join", spy)
    out = port_cli(["join", "--key64", "-r", str(NR), "-s", str(NS),
                    "--reps", "1", "--quiet", *flags])
    assert seen == [(torch.int64,) * 3 + (True,)]
    want = NS
    if "-z" in flags:
        r = create_relation_pk(NR, seed=11111, dtype=torch.int64,
                               device="cpu")
        s = create_relation_zipf(NS, NR, 1.5, seed=22222, dtype=torch.int64,
                                 device="cpu")
        want = int(mergejoin.merge_join_count(r.key, r.payload, s.key,
                                              s.payload).matches)
    assert _tuples(out) == _json(out)["matches"] == want
    assert _json(out)["alg"] == flags[1]


@pytest.mark.parametrize("argv", [
    ["join", "-r", "16", "-s", "64"],
    ["tpch", "-q", "12", "--scale", "0.001"],
    ["scan", "--rows", "1024"],
    ["matrix", "--sizes", "16x64"],
], ids=lambda a: a[0])
def test_without_device_cpu_raises_here(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmain.main(argv)

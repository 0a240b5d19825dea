"""The port stands alone: no jax, nothing of aqp_tpu, no PyTorch extension
tooling, and no silent fall back to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "aqp_tpu_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                     ROOT / "sort_check.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "aqp_tpu")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['aqp_tpu'] = None; "
            "import aqp_tpu_torch, aqp_tpu_torch.engine, "
            "aqp_tpu_torch.joins.api, aqp_tpu_torch.data, "
            "aqp_tpu_torch.ops.kernels.rho3, "
            "aqp_tpu_torch.ops.kernels.compact, "
            "aqp_tpu_torch.ops.kernels.lanecompact, "
            "aqp_tpu_torch.ops.kernels.scan, "
            "aqp_tpu_torch.ops.kernels.aggpipe, "
            "aqp_tpu_torch.ops.kernels.nphj, "
            "aqp_tpu_torch.ops.kernels.rstats, "
            "aqp_tpu_torch.ops.scan, aqp_tpu_torch.ops.aggregate, "
            "aqp_tpu_torch.ops.hashing, aqp_tpu_torch.joins.nopart, "
            "aqp_tpu_torch.joins.skewtier, "
            "aqp_tpu_torch.ops.kernels.blocksort, "
            "aqp_tpu_torch.ops.partition, aqp_tpu_torch.ops.segops, "
            "aqp_tpu_torch.joins.sortmerge, "
            "aqp_tpu_torch.experiments.partition_bench, "
            "aqp_tpu_torch.experiments.membench, "
            "aqp_tpu_torch.experiments.sweep, "
            "aqp_tpu_torch.experiments.join_overview, "
            "aqp_tpu_torch.experiments.skew, "
            "aqp_tpu_torch.experiments.selectivity, "
            "aqp_tpu_torch.experiments.scaling, "
            "aqp_tpu_torch.experiments.exact_core, "
            "aqp_tpu_torch.queries, aqp_tpu_torch.queries.tables, "
            "aqp_tpu_torch.queries.filters, aqp_tpu_torch.queries.tpch, "
            "aqp_tpu_torch.queries.fused, aqp_tpu_torch.data.tpch_dbgen, "
            "aqp_tpu_torch.data.tpch_loader, aqp_tpu_torch.__main__, "
            "aqp_tpu_torch.harness, aqp_tpu_torch.harness.runner, "
            "aqp_tpu_torch.utils, aqp_tpu_torch.utils.logging, "
            "aqp_tpu_torch.utils.profiler, aqp_tpu_torch.utils.timing, "
            "aqp_tpu_torch.data.native, aqp_tpu_torch.ops.streamjoin, "
            "aqp_tpu_torch.parallel, aqp_tpu_torch.parallel.mesh, "
            "aqp_tpu_torch.parallel.bringup, "
            "aqp_tpu_torch.parallel.shuffle, "
            "aqp_tpu_torch.parallel.dist_join, "
            "aqp_tpu_torch.parallel.skew, "
            "aqp_tpu_torch.experiments.weak_scaling, "
            "aqp_tpu_torch.experiments.rho_phases, "
            "aqp_tpu_torch.experiments.roofline, "
            "aqp_tpu_torch.experiments.scan_bench, "
            "aqp_tpu_torch.experiments.aggregate_bench, "
            "aqp_tpu_torch.experiments.tpch_bench, "
            "aqp_tpu_torch.experiments.cracking, "
            "aqp_tpu_torch.experiments.dist_forms, "
            "aqp_tpu_torch.ops.kernels.held; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_extension_builder():
    for path in sorted(PKG.rglob("*")):
        if path.is_file() and path.suffix in (".py", ".cu", ".cuh"):
            assert "cpp_extension" not in path.read_text(), path
            if path.suffix in (".cu", ".cuh"):
                assert "#include <torch" not in path.read_text(), path


def test_entry_points_without_device_raise_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    from aqp_tpu_torch import default_device
    from aqp_tpu_torch.data import (create_relation_fk,
                                    create_relation_fk_sel,
                                    create_relation_pk,
                                    create_relation_zipf)
    from aqp_tpu_torch import engine
    from aqp_tpu_torch.joins.api import finalize_join, run_join
    from aqp_tpu_torch.relation import Relation

    r = Relation.from_numpy(np.arange(1, 5, dtype=np.int32), device="cpu")
    cols = (r.key, r.payload, r.key, r.payload)
    calls = [
        default_device,
        lambda: create_relation_pk(16),
        lambda: create_relation_fk(32, 16),
        lambda: create_relation_fk_sel(32, 16, 50.0),
        lambda: create_relation_zipf(32, 16, 1.5),
        lambda: Relation.from_numpy(np.arange(4, dtype=np.int32)),
        lambda: run_join(r, r),
        lambda: run_join(r, r, "PHT"),
        lambda: run_join(r, r, "NPBC_st"),
        lambda: run_join(r, r, "RHO_seq"),
        lambda: run_join(r, r, "RHT"),
        lambda: run_join(r, r, "RSM"),
        lambda: run_join(r, r, "MWAY"),
        lambda: run_join(r, r, "PSM"),
        lambda: finalize_join(r, r, None, None),
        lambda: engine.rho_join_count_fused(*cols),
        lambda: engine.rho_join_count_checked(*cols),
        lambda: engine.rho_join_count(*cols),
        lambda: engine.rho_join_materialize_fused(*cols),
        lambda: engine.rho_join_materialize(*cols, 128),
    ]
    from aqp_tpu_torch.data import tpch_loader
    from aqp_tpu_torch.queries import tables

    calls += [
        lambda: tables.generate_tpch_tables(0.001),
        lambda: tables.NationTable.from_numpy(
            {"key": np.arange(25, dtype=np.int32),
             "rowid": np.arange(25, dtype=np.int32)}),
        *(lambda f=f: getattr(tpch_loader, f)("no-such-store")
          for f in ("load_lineitem", "load_orders", "load_customer",
                    "load_part", "load_nation")),
    ]
    from aqp_tpu_torch.experiments import membench, partition_bench
    from aqp_tpu_torch.ops import aggregate, scan
    from aqp_tpu_torch.ops.kernels import aggpipe
    from aqp_tpu_torch.ops.kernels import scan as kscan

    col = torch.zeros(128 * 256, dtype=torch.uint8)
    calls += [
        lambda: scan.scan_count(col, 1, 2),
        lambda: scan.scan_sum(col, 1, 2),
        lambda: scan.scan_bitvector(col, 1, 2),
        lambda: scan.scan_index(col, 1, 2, 8),
        lambda: scan.scan_values(col, 1, 2, 8),
        lambda: scan.scan_dict(col, r.key, 1, 2, 8),
        lambda: scan.scan_dict_full(col, r.key),
        lambda: scan.scan_count_streamed(col, 1, 2),
        lambda: kscan.scan_count_pallas(col, 1, 2, sub=256),
        lambda: kscan.scan_sum_pallas(col, 1, 2, sub=256),
        lambda: kscan.scan_bitvector_pallas(col, 1, 2, sub=256),
        lambda: kscan.scan_index_pallas(col, 1, 2, 8),
        lambda: kscan.scan_values_pallas(col, 1, 2, 8),
        lambda: kscan.scan_dict_pallas(col, r.key, r.key, 1, 2, 8),
        lambda: aggregate.groupby_aggregate(r.key, r.payload, 8),
        lambda: aggregate.radix_sort_pairs(r.key, r.payload),
        lambda: aggpipe.groupby_aggregate_routed(r.key, r.payload, 8),
        lambda: aggpipe.groupby_aggregate_routed_auto(r.key, r.payload, 8),
        lambda: partition_bench.main(["--small"]),
        lambda: membench.main(["--small"]),
    ]
    from aqp_tpu_torch.experiments import (join_overview, scaling,
                                           selectivity, skew)

    calls += [lambda m=m: m.main(["--small"])
              for m in (join_overview, skew, selectivity, scaling)]
    calls += [lambda: join_overview.main(["--small", "--key64"])]
    from aqp_tpu_torch.__main__ import main as cli_main
    from aqp_tpu_torch.harness import (ExperimentConfig, run_experiments,
                                       run_experiments_pipelined)
    from aqp_tpu_torch.ops.streamjoin import streaming_join_count

    calls += [
        lambda: streaming_join_count(r, []),
        lambda: cli_main(["join", "-r", "16", "-s", "64"]),
        lambda: run_experiments(ExperimentConfig(sizes=((16, 64),))),
        lambda: run_experiments_pipelined(ExperimentConfig(
            sizes=((16, 64),))),
    ]
    from aqp_tpu_torch.experiments import weak_scaling
    from aqp_tpu_torch.parallel import make_mesh
    from aqp_tpu_torch.parallel.mesh import make_mesh_2d

    calls += [make_mesh, make_mesh_2d,
              lambda: weak_scaling.main(["--small"])]
    from aqp_tpu_torch.experiments import (aggregate_bench, cracking,
                                           rho_phases, roofline, scan_bench,
                                           tpch_bench)

    calls += [lambda m=m: m.main(["--small"])
              for m in (rho_phases, roofline, scan_bench, aggregate_bench,
                        tpch_bench, cracking)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _tiny_drivers(monkeypatch) -> dict:
    """The six drivers' modules -> their argv, at sizes cut to a few
    thousand rows (tpch_bench's staged joins by PSM; no output flag)."""
    from aqp_tpu_torch.experiments import (aggregate_bench, cracking,
                                           rho_phases, roofline, scan_bench,
                                           tpch_bench)

    for mod in (rho_phases, roofline, cracking):
        monkeypatch.setitem(mod.SIZES, True, (1 << 10, 1 << 12))
    monkeypatch.setattr(rho_phases, "FUSED_REPS", 1)
    monkeypatch.setattr(roofline, "REPS", 1)
    monkeypatch.setitem(scan_bench.SELECTIVITY_ROWS, True,
                        {m: 1 << 14 for m in scan_bench.MODES})
    monkeypatch.setitem(scan_bench.SCALEUP_ROWS, True, (1 << 14,))
    monkeypatch.setitem(scan_bench.RESIDENCY_ROWS, True, 1 << 14)
    monkeypatch.setitem(aggregate_bench.ROWS_LOG2, True, 12)
    monkeypatch.setitem(aggregate_bench.EXPONENTS, True, (4,))
    cpu = ["--small", "--device", "cpu"]
    return {rho_phases: cpu, roofline: cpu,
            scan_bench: cpu + ["--reps", "1"],
            aggregate_bench: cpu + ["--reps", "1"],
            tpch_bench: cpu + ["--synthetic", "--scale", "0.001", "--reps",
                               "1", "--algorithm", "PSM"],
            cracking: cpu + ["--queries", "1"]}


def test_drivers_write_nothing_without_their_output_flag(tmp_path,
                                                         monkeypatch):
    """rho_phases, roofline, scan_bench, aggregate_bench, tpch_bench
    (synthetic tables: the dbgen store is the only other file it writes)
    and cracking, run in an empty directory without --csv / --out /
    --csv-dir: the directory stays empty (the JAX drivers write under
    results/)."""
    runs = _tiny_drivers(monkeypatch)
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # the suite's six workers share the cores
    try:
        for mod, argv in runs.items():
            assert mod.main(argv)
            assert list(tmp_path.iterdir()) == [], mod.__name__
    finally:
        torch.set_num_threads(threads)


def test_kernel_wrappers_reject_other_devices():
    from aqp_tpu_torch.ops.kernels import (aggpipe, blocksort, compact,
                                           lanecompact, nphj, rho3, rstats,
                                           scan)

    meta = torch.zeros(8, dtype=torch.int32, device="meta")
    rows = torch.zeros((4, 128), dtype=torch.int32, device="meta")
    slots = torch.zeros((2, 1, 2, 128), dtype=torch.int32, device="meta")
    calls = [
        lambda: rho3.k1(meta, None, 8, rho3.Rho3Params(), 1.0),
        lambda: rho3.k3m(slots, slots, meta[:4].view(2, 1, 2), 1),
        lambda: lanecompact._compact_windows(meta, [meta], 0, 1, 8, (0,)),
        lambda: compact.scatter_segments(rows, rows, meta[:1], meta[:1],
                                         meta[:1], 1, 5),
        lambda: compact.scatter_segments_one(rows, meta[:1], meta[:1],
                                             meta[:1], 1, 5),
        lambda: scan.count(meta.to(torch.uint8), 0, 1),
        lambda: scan.bitvector(meta.to(torch.uint8), 0, 1),
        lambda: lanecompact._compact_windows(meta.to(torch.uint8), [], 0, 1,
                                             8, (), with_ids=True),
        lambda: aggpipe.k3agg(slots, slots, meta[:4].view(2, 1, 2)),
        lambda: nphj.k3two(slots, None, meta[:4].view(2, 1, 2), slots, None,
                           meta[:4].view(2, 1, 2)),
        lambda: nphj.k3two_mat(slots, slots, meta[:4].view(2, 1, 2), slots,
                               slots, meta[:4].view(2, 1, 2), 1),
        lambda: rstats.r_cand_stats_kernel(meta, meta, meta[:4]),
        lambda: blocksort.sort_blocks(meta, meta, 128),
        lambda: compact.sort_hist(meta, meta, 0.0, 128, 1),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()

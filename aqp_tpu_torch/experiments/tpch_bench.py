"""TPC-H query benchmark (counterpart of experiments/tpch_bench.py), the
analog of the reference's paper-8-full-query-optimization-impact.py: the
per-query impact of the plan.  Two plans of Q3, Q10, Q12 and Q19:

  staged  queries/tpch.py: filter, join and materialize phases (the
          reference's selection_1 / join_1 timer contract, tpch.cpp:
          36-309), a call timed on the host clock as the plan's
          Timings.total; 1 warm-up, then --reps rows;
  fused   queries/fused.py: no host round trip inside a query; the mean of
          --reps calls after a warm-up (CUDA events on the card), written
          as --reps equal rows.  A fused plan whose bound was exceeded (ok
          false) is skipped with the reference's message: the staged plan
          serves that scale.

Throughput is the reference's convention (tpch.cpp:111-114): the query's
input-table rows (lineitem, orders, customer, part, nation as it reads
them) over the seconds.  The tables come from the dbgen store
(data/tpch_dbgen.ensure_generated under --store, written once, then
data/tpch_loader onto the device) or, with --synthetic, from
queries.generate_tpch_tables.

    python -m aqp_tpu_torch.experiments.tpch_bench [--small] \\
        [--scale SF] [--synthetic] [--store DIR] [--reps 3] \\
        [--algorithm RHO] [--csv out.csv] [--device cuda|cpu]

SF 1 (0.01 with --small) unless --scale says otherwise.  The card is the
default; --device cpu runs every step on the CPU.  Nothing but the dbgen
store is written without --csv.
"""

from __future__ import annotations

import argparse
import time

import torch

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.queries import fused, tpch
from aqp_tpu_torch.queries.tables import generate_tpch_tables
from aqp_tpu_torch.utils.timing import hard_sync, mean_ms

CSV_HEADER = "query,scale,plan,alg,rep,throughput_mrows,matches,source"
QUERIES = ("Q3", "Q10", "Q12", "Q19")
STAGED = {"Q3": tpch.tpch_q3, "Q10": tpch.tpch_q10, "Q12": tpch.tpch_q12,
          "Q19": tpch.tpch_q19}
FUSED = {"Q3": fused.tpch_q3_fused, "Q10": fused.tpch_q10_fused,
         "Q12": fused.tpch_q12_fused, "Q19": fused.tpch_q19_fused}


def load_disk_tables(scale: float, store: str, device):
    """The dbgen store at `scale` under `store` (generated once), loaded
    onto `device`: (lineitem, orders, customer, part, nation)."""
    from aqp_tpu_torch.data import tpch_dbgen, tpch_loader

    t0 = time.perf_counter()
    base = tpch_dbgen.ensure_generated(scale, root=store)
    t1 = time.perf_counter()
    tables = tuple(getattr(tpch_loader, f"load_{name}")(base, device=device)
                   for name in ("lineitem", "orders", "customer", "part",
                                "nation"))
    hard_sync([t.key for t in tables])
    print(f"disk tables sf={scale}: generate {t1 - t0:.1f}s, "
          f"load+upload {time.perf_counter() - t1:.1f}s "
          f"({tables[0].num_tuples} lineitems)", flush=True)
    return tables


def plan_args(l, o, c, p, n) -> dict:
    """Each query's tables, in its plans' order."""
    return {"Q3": (c, o, l), "Q10": (c, o, l, n), "Q12": (l, o),
            "Q19": (l, p)}


def input_rows(l, o, c, p, n) -> dict:
    """The reference's throughput rows: the tables a query reads."""
    lrows = l.shipdate.shape[0]
    return {"Q3": lrows + o.num_tuples + c.num_tuples,
            "Q10": lrows + o.num_tuples + c.num_tuples + n.num_tuples,
            "Q12": lrows + o.num_tuples,
            "Q19": lrows + p.num_tuples}


def main(argv=None) -> list:
    """Run both plans; returns the rows (query, scale, plan, alg, rep, M
    rows/s, matches, source)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--store", default="data",
                    help="the dbgen store's root directory")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--algorithm", default="RHO")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={name}", flush=True)
    scale = args.scale if args.scale is not None else (
        0.01 if args.small else 1.0)
    source = "synthetic" if args.synthetic else "disk"
    tables = (generate_tpch_tables(scale=scale, device=dev)
              if args.synthetic else
              load_disk_tables(scale, args.store, dev))
    qargs, nrows = plan_args(*tables), input_rows(*tables)
    alg, reps = args.algorithm, args.reps
    rows = []
    for q in QUERIES:
        STAGED[q](*qargs[q], algorithm=alg)   # warm-up
        for rep in range(reps):
            res = STAGED[q](*qargs[q], algorithm=alg)
            t = res.timings
            print(f"{q} staged sf={scale} alg={alg} rep={rep}: "
                  f"{t.mrows_per_s:.1f} M rows/s matches={res.matches} "
                  f"phases={ {k: round(v, 4) for k, v in t.phases.items()} }",
                  flush=True)
            rows.append((q, scale, "staged", alg, rep,
                         round(t.mrows_per_s, 2), int(res.matches), source))
    for q in QUERIES:
        m, ok = FUSED[q](*qargs[q])
        matches = int(m)
        if not bool(ok):
            print(f"{q} fused sf={scale}: bounds overflowed - skipping "
                  "(staged plan serves this scale)", flush=True)
            continue
        ms, (m, ok) = mean_ms(lambda: FUSED[q](*qargs[q]), dev, reps)
        if int(m) != matches or not bool(ok):
            raise RuntimeError(f"{q} fused: {int(m)} matches (ok "
                               f"{bool(ok)}) after {matches}")
        mrs = nrows[q] / ms / 1e3
        print(f"{q} fused sf={scale}: {mrs:.1f} M rows/s "
              f"matches={matches} ({ms:.1f} ms/query)", flush=True)
        for rep in range(reps):
            rows.append((q, scale, "fused", "RHO", rep, round(mrs, 2),
                         matches, source))

    if args.csv:
        with open(args.csv, "w") as f:
            f.write(CSV_HEADER + "\n")
            for r in rows:
                f.write(",".join(map(str, r)) + "\n")
        print(f"wrote {args.csv} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()

"""Multi-query cracking amortization (counterpart of
experiments/cracking.py), CrkJoin's core claim: the reference's
CrkJoin/JoinWrapper.cpp runs a sequence of queries against one
progressively cracked store, the first query paying for the cracking and
the later ones reusing it.  Three variants, --queries joins each:

  cracked_reuse  one persistent CrackedRelation pair
                 (joins/crk.crack_relation), each query on the stores the
                 last returned (crk_join_cracked); one warm-up on fresh
                 stores first;
  cracked_fresh  fresh stores every query: the cracking paid each time;
  rho_eager      run_join(..., "RHO"), the non-cracking engine, after a
                 warm-up.

A query is timed on the host clock until the device has finished it (the
reference's per-query contract); throughput = (|R| + |S|) / s.  depth and
key bits are the reference's: ceil(log2(|R| / partition_rows)) levels of a
ceil(log2 |R|) + 1-bit key domain.

    python -m aqp_tpu_torch.experiments.cracking [--small] \\
        [--queries 8] [--csv out.csv] [--device cuda|cpu]

13,107,200 PK x 52,428,800 FK keys (2^16 x 2^18 with --small), seeds 501
and 502.  The card is the default; --device cpu runs the kernels' plain
versions.  Nothing is written without --csv.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.data import create_relation_fk, create_relation_pk
from aqp_tpu_torch.joins.api import run_join
from aqp_tpu_torch.joins.crk import crack_relation, crk_join_cracked
from aqp_tpu_torch.utils.timing import hard_sync

CSV_HEADER = "variant,query,seconds,throughput_mrows"
SIZES = {False: (13_107_200, 52_428_800), True: (1 << 16, 1 << 18)}
SEEDS = (501, 502)
VARIANTS = ("cracked_reuse", "cracked_fresh", "rho_eager")


def crack_geometry(nr: int, cfg: JoinConfig) -> tuple:
    """(depth, key bits) of the reference's study for an R of nr rows."""
    depth = max(1, math.ceil(math.log2(max(2, nr / cfg.partition_rows))))
    kb = max(1, math.ceil(math.log2(max(2, nr)))) + 1
    return depth, kb


def main(argv=None) -> list:
    """Run the three variants; returns the rows: the CSV's columns
    (variant, query, seconds, M rows/s), then the query's matches."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--csv", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={name}", flush=True)
    nr, ns = SIZES[args.small]
    relR = create_relation_pk(nr, seed=SEEDS[0], device=dev)
    relS = create_relation_fk(ns, nr, seed=SEEDS[1], device=dev)
    hard_sync((relR.key, relS.key))
    cfg = JoinConfig()
    depth, kb = crack_geometry(nr, cfg)
    total = nr + ns
    rows = []

    def timed(variant, q, call):
        """call() returns (result, ...): crk_join_cracked's stores or
        run_join's timings after it.  Returns call()'s output."""
        t0 = time.perf_counter()
        out = call()
        hard_sync(out[0])
        dt = time.perf_counter() - t0
        rows.append((variant, q, round(dt, 6), round(total / dt / 1e6, 2),
                     int(out[0].matches)))
        print(f"{variant:14s} q{q}: {dt * 1e3:8.2f} ms "
              f"({total / dt / 1e6:8.1f} M rows/s)", flush=True)
        return out

    def fresh():
        return crack_relation(relR, kb), crack_relation(relS, kb)

    crk_join_cracked(*fresh(), cfg, depth)          # warm-up
    crR, crS = fresh()
    for q in range(args.queries):
        _, crR, crS = timed("cracked_reuse", q,
                            lambda: crk_join_cracked(crR, crS, cfg, depth))
    for q in range(args.queries):
        timed("cracked_fresh", q,
              lambda: crk_join_cracked(*fresh(), cfg, depth))
    run_join(relR, relS, "RHO", cfg, device=dev)    # warm-up
    for q in range(args.queries):
        timed("rho_eager", q,
              lambda: run_join(relR, relS, "RHO", cfg, device=dev))

    if args.csv:
        with open(args.csv, "w") as f:
            f.write(CSV_HEADER + "\n")
            for r in rows:
                f.write(",".join(map(str, r[:4])) + "\n")
        print(f"wrote {args.csv} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()

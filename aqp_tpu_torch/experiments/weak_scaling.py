"""Weak and strong scaling over ranks (counterpart of
experiments/weak_scaling.py): the thread-scaling analog of the SGXv2
paper's studies (SGXv2Scripts/scripts/paper-3*, 3_numa.sh), throughput
against the rank count.  Weak scaling keeps the work a rank fixed (ideal:
flat time), strong scaling the total (ideal: 1/n time), broadcast keeps R
fixed and small (the ring's design regime: R rotates in full past every
rank) while S grows with the ranks.  The hash-shuffle join and the
overlapped ring join are both timed.

One process a rank (parallel.bringup.spawn_ranks): the cards on cuda
(NCCL, one rank a card), or --ranks gloo processes on the CPU.  For each
rank count n of 1, 2, 4, 8, 16 up to --ranks, ranks 0 .. n - 1 form the
mesh and the others wait.  Rank 0 prints one line a row; --csv writes the
JAX script's columns (nothing is written without it).

    python -m aqp_tpu_torch.experiments.weak_scaling [--small] [--reps 3] \\
        [--ranks N] [--csv out.csv] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.data import create_relation_fk, create_relation_pk
from aqp_tpu_torch.parallel.bringup import spawn_ranks
from aqp_tpu_torch.parallel.dist_join import (
    make_dist_join_count, make_dist_join_count_ring)
from aqp_tpu_torch.parallel.mesh import make_mesh, shard_relation
from aqp_tpu_torch.utils.timing import hard_sync

CSV_HEADER = "mode,devices,engine,total_rows,seconds,throughput_mrows"
ENGINES = ("shuffle", "ring")
MODES = ("weak", "strong", "broadcast")
RANK_COUNTS = (1, 2, 4, 8, 16)
TIMEOUT_S = 1800.0                  # every rank's whole run, bring-up included


def configs(small: bool = False, ranks: int = 1) -> list:
    """The study's matrix: (mode, ranks n, |R|, |S|) in run order."""
    counts = [n for n in RANK_COUNTS if n <= ranks]
    per_r, per_s = (1 << 12, 1 << 14) if small else (1 << 17, 1 << 19)
    out = []
    for mode in MODES:
        for n in counts:
            if mode == "weak":
                nr, ns = per_r * n, per_s * n
            elif mode == "strong":
                nr, ns = per_r * counts[-1], per_s * counts[-1]
            else:
                nr, ns = per_r, per_s * n
            out.append((mode, n, nr, ns))
    return out


def bench(fn, args, reps: int) -> tuple:
    """(least seconds of a call over `reps` after one warm-up, matches),
    each call to its last device sync."""
    out = hard_sync(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = hard_sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, int(out[0])


def _rank_rows(rank: int, world: int, small: bool, reps: int,
               device: str) -> list:
    """Every configuration on this rank (a member of the first n ranks, or
    waiting); rank 0 prints and returns the rows."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for mode, n, nr, ns in configs(small, world):
        mesh = make_mesh(n, device=dev.type)
        if mesh.get_coordinate() is not None:
            relR = create_relation_pk(nr, seed=601, device=dev)
            relS = create_relation_fk(ns, nr, seed=602, device=dev)
            R = shard_relation(relR, mesh)
            S = shard_relation(relS, mesh)
            for engine, fn in (
                    ("shuffle", make_dist_join_count(mesh, R.num_tuples,
                                                     S.num_tuples)),
                    ("ring", make_dist_join_count_ring(mesh))):
                t, m = bench(fn, (R.key, R.payload, S.key, S.payload), reps)
                if m != ns:
                    raise RuntimeError(f"{mode} n={n} {engine}: {m} matches,"
                                       f" |S| = {ns}")
                mrs = (nr + ns) / t / 1e6
                if rank == 0:
                    print(f"{mode:6s} n={n} {engine:8s} {t * 1e3:9.2f} ms "
                          f"{mrs:9.1f} M rows/s matches={m}", flush=True)
                rows.append({"mode": mode, "devices": n, "engine": engine,
                             "total_rows": nr + ns, "seconds": round(t, 6),
                             "throughput_mrows": round(mrs, 2),
                             "matches": m})
            del relR, relS, R, S
        dist.barrier()
    return rows if rank == 0 else []


def main(argv: Optional[List[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes, one a rank (default: every card; 1 "
                         "on the CPU)")
    ap.add_argument("--csv", default=None,
                    help="write the rows here (nothing is written without)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ranks = args.ranks or (torch.cuda.device_count() if dev.type == "cuda"
                           else 1)
    rows = spawn_ranks(_rank_rows, ranks, (args.small, args.reps, dev.type),
                       timeout_s=TIMEOUT_S)[0]
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(CSV_HEADER + "\n")
            for r in rows:
                f.write(",".join(str(r[c]) for c in CSV_HEADER.split(","))
                        + "\n")
        print(f"wrote {args.csv} ({len(rows)} rows, device {dev.type})",
              flush=True)
    return rows


if __name__ == "__main__":
    main()

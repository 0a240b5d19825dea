"""RHO per-phase breakdown (counterpart of experiments/rho_phases.py), the
analog of the reference's RHO-phases study, which times partition, build
and probe apart (radix_join.cpp print_timing).  Two plan forms:

  staged  run_join(..., "RHO"): the dispatcher's phases as its PhaseTimer
          records them (CUDA events on the card), 3 reps after a warm-up;
  fused   the rho3 pipeline split at its kernel boundaries, keys-only:
          pack (rho3.pack_pair alone: pack_keys with the R/S
          concatenation), partition_k1k2 (_partition_2level: pack + K1
          + K2), join_k3
          (the whole count less partition_k1k2) and total
          (rho_join_count_v3 with_checksum=False); each the mean of 5
          calls after a warm-up.  `pack` is a part of partition_k1k2.

    python -m aqp_tpu_torch.experiments.rho_phases [--small] \\
        [--csv out.csv] [--device cuda|cpu]

13,107,200 PK x 52,428,800 FK keys (2^16 x 2^18 with --small), seeds 555
and 777.  The card is the default; --device cpu runs the kernels' plain
versions (the fused rows too).  Nothing is written without --csv.
"""

from __future__ import annotations

import argparse

import torch

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.data import create_relation_fk, create_relation_pk
from aqp_tpu_torch.joins.api import run_join
from aqp_tpu_torch.ops.kernels.rho3 import (HASH_C, Rho3Params,
                                            _partition_2level, pack_pair,
                                            rho_join_count_v3)
from aqp_tpu_torch.utils.timing import mean_ms

CSV_HEADER = "plan,phase,rep,seconds"
SIZES = {False: (13_107_200, 52_428_800), True: (1 << 16, 1 << 18)}
SEEDS = (555, 777)
STAGED_REPS = 3
FUSED_REPS = 5


def fused_calls(rk, rp, sk, sp, prm: Rho3Params) -> dict:
    """The fused pipeline's three timed calls, keys-only."""
    return {
        "pack": lambda: pack_pair(rk, sk, HASH_C),
        "partition_k1k2": lambda: _partition_2level(
            rk, rp, sk, sp, prm, HASH_C, False, None),
        "total": lambda: rho_join_count_v3(rk, rp, sk, sp, prm,
                                           with_checksum=False),
    }


def main(argv=None) -> list:
    """Run both plans; returns the rows: the CSV's columns (plan, phase,
    rep, seconds), then the matches of the call the row comes from (None
    for the fused pack and partition rows)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={name}", flush=True)
    nr, ns = SIZES[args.small]
    relR = create_relation_pk(nr, seed=SEEDS[0], device=dev)
    relS = create_relation_fk(ns, nr, seed=SEEDS[1], device=dev)
    rows = []

    run_join(relR, relS, "RHO", device=dev)      # warm-up
    for rep in range(STAGED_REPS):
        res, t = run_join(relR, relS, "RHO", device=dev)
        for phase, secs in t.phases.items():
            rows.append(("staged", phase, rep, round(secs, 6),
                         int(res.matches)))

    ms = {}
    for phase, fn in fused_calls(relR.key, relR.payload, relS.key,
                                 relS.payload, Rho3Params()).items():
        ms[phase], out = mean_ms(fn, dev, FUSED_REPS)
    m, _, ovf = out
    if int(ovf):
        raise RuntimeError(f"the fused pipeline overflowed ({int(ovf)}) on "
                           "an FK workload")
    secs = {k: v / 1e3 for k, v in ms.items()}
    rows += [("fused", "pack", 0, round(secs["pack"], 6), None),
             ("fused", "partition_k1k2", 0,
              round(secs["partition_k1k2"], 6), None),
             ("fused", "join_k3", 0,
              round(max(0.0, secs["total"] - secs["partition_k1k2"]), 6),
              int(m)),
             ("fused", "total", 0, round(secs["total"], 6), int(m))]
    for r in rows:
        print(",".join(map(str, r[:4])), flush=True)

    if args.csv:
        with open(args.csv, "w") as f:
            f.write(CSV_HEADER + "\n")
            for r in rows:
                f.write(",".join(map(str, r[:4])) + "\n")
        print(f"wrote {args.csv} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()

"""The exact sort core (ops/mergejoin.py) on int32 keys at the overview's
size, on the card: PK R of 13,107,200 keys, FK S of 52,428,800, seeded
random payloads.

    python -m aqp_tpu_torch.experiments.exact_core [--reps 5]

Times, in milliseconds a call (CUDA events around `reps` calls after a
warm-up): the core's three entry points (merge_join_count_keys,
merge_join_count, merge_join_materialize at capacity |S|) and PSM through
run_join keys-only, checksummed and materialized.  Prints the card's name
and power limit, then one JSON line with the times and each call's
matches and checksum.  It calls only what older checkouts of the package
also have, so a copy of this file run from the root of such a checkout
measures that checkout's core.  A machine without a CUDA card exits 2.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys

import torch

from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.data import create_relation_fk, create_relation_pk
from aqp_tpu_torch.joins.api import run_join
from aqp_tpu_torch.ops import mergejoin

NR, NS = 13_107_200, 52_428_800


def call_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def calls(r, s) -> dict:
    """label -> a call of the exact core on relations r and s."""
    out = {
        "merge_join_count_keys": functools.partial(
            mergejoin.merge_join_count_keys, r.key, s.key),
        "merge_join_count": functools.partial(
            mergejoin.merge_join_count, r.key, r.payload, s.key, s.payload),
        "merge_join_materialize": functools.partial(
            mergejoin.merge_join_materialize, r.key, r.payload, s.key,
            s.payload, s.num_tuples),
    }
    for label, cfg in (("PSM keys-only", JoinConfig(checksum=False)),
                       ("PSM checksummed", JoinConfig()),
                       ("PSM materialize", JoinConfig(materialize=True))):
        out[label] = functools.partial(
            lambda c: run_join(r, s, "PSM", c, device=r.device)[0], cfg)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("exact_core: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    r = create_relation_pk(NR, random_payload=True, device="cuda")
    s = create_relation_fk(NS, NR, random_payload=True, device="cuda")
    out = {}
    for label, fn in calls(r, s).items():
        res = fn()
        out[label] = {"ms": call_ms(fn, args.reps),
                      "matches": int(res.matches),
                      "checksum": int(res.checksum)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

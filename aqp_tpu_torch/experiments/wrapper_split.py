"""Host issue against device time for the calls of RSTATS and the two
segment scatters, at the main path's shapes, on the card.

    python -m aqp_tpu_torch.experiments.wrapper_split [--reps 5] [--only LABEL]

For each call: RSTATS keys-only and with payloads over bench.py's R
(13,107,200 dense keys, seeded random payloads) with the 64 heavy
candidates of a z = 1.5 Zipf S of 52,428,800 keys, and scatter_segments /
scatter_segments_one on that S's compacted residual (the windows of 512
rows the skew tier's compaction makes, at its planned capacity):

  ops      the device operations one call issues (kernels, memsets,
           copies), each with its count a call (rounded) and its device
           microseconds a launch, from torch.profiler over `reps` calls
           after a warm-up;
  host_us  the host's microseconds to issue one call (200 calls with no
           synchronisation between them);
  call_ms  one call's milliseconds as chip_smoke.py's kernel rows time it
           (CUDA events around `reps` calls after a warm-up).

Prints one JSON line.  `--only LABEL` measures that one call, so that its
profiler session is the first of a fresh process (in a process that
profiled before, the profiler drops device records).  It calls only what
older checkouts of the package also have, so a copy of this file run from
the root of such a checkout measures that checkout's calls.  A machine without a CUDA card exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from aqp_tpu_torch.data import create_relation_pk, create_relation_zipf
from aqp_tpu_torch.joins import skewtier
from aqp_tpu_torch.ops.kernels import compact, lanecompact, rstats

NR, NS = 13_107_200, 52_428_800
W = 512                                # the compaction's window, in rows
HOST_CALLS = 200
LABELS = ("RSTATS keys-only", "RSTATS with payloads", "scatter_segments",
          "scatter_segments_one")


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


def host_us(fn) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    return us


def device_ops(fn, reps: int) -> dict:
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # an operation runs a whole number of times a call, and the profiler
    # can lose a record (in a process that profiled before, the first of
    # a session's) but never adds one: round the count a call
    return {ev.key.replace("(anonymous namespace)::", "").split("(")[0]:
            {"per_call": round(ev.count / reps),
             "us_each": ev.device_time_total / max(ev.count, 1)}
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA}


def calls() -> dict:
    """{label: a no-argument call} at the main path's shapes."""
    rel_r = create_relation_pk(NR, random_payload=True, device="cuda")
    zs = create_relation_zipf(NS, NR, 1.5, seed=22222, random_payload=True,
                              device="cuda")
    hk = skewtier.heavy_candidates(zs.key)
    rk, rp = rel_r.key, rel_r.payload
    rcnt, rph = skewtier.r_cand_stats(rk, rp, hk)
    pres = (hk >= 0) & (rcnt > 0)
    _, _, sk_res = skewtier.heavy_split_pass(zs.key, zs.payload, hk, pres,
                                             rph)
    _, cap = skewtier.skew_plan(zs.key)
    ow = lanecompact.out_w_for(W, min(1.0, cap * 128 / NS))
    keep = (lanecompact.INT32_MIN + 1, lanecompact.PAD_R_INPUT - 1)
    fill = lanecompact.PAD_S_INPUT
    pair, counts = lanecompact._compact_windows(
        sk_res, [sk_res, zs.payload], *keep, W, (fill, 0), ow)
    key, _ = lanecompact._compact_windows(sk_res, [sk_res], *keep, W,
                                          (fill,), ow)
    desc, _, _ = lanecompact._segments(counts, ow, cap)
    nb = counts.numel()
    ks, ps = (b.view(nb * ow, 128) for b in pair)
    k1 = key[0].view(nb * ow, 128)
    return {
        "RSTATS keys-only": lambda: rstats.r_cand_stats_kernel(
            rk, rp, hk, False),
        "RSTATS with payloads": lambda: rstats.r_cand_stats_kernel(
            rk, rp, hk, True),
        "scatter_segments": lambda: compact.scatter_segments(
            ks, ps, *desc, nb, cap + 1, fill),
        "scatter_segments_one": lambda: compact.scatter_segments_one(
            k1, *desc, nb, cap + 1, fill),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", choices=LABELS, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wrapper_split: no CUDA device is available", file=sys.stderr)
        return 2
    out = {"device": torch.cuda.get_device_name(0)}
    for label, fn in calls().items():
        if args.only not in (None, label):
            continue
        out[label] = {"ops": device_ops(fn, args.reps),
                      "host_us": host_us(fn),
                      "call_ms": call_ms(fn, args.reps)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Radix-partition microbenchmark (counterpart of
experiments/partition_bench.py), the analog of the reference's
RadixPartitioning microbenchmark (Scan-Micro-Benchmarks, App/Histogram.cpp:
20-30), which isolates the radix join's histogram and partition-scatter
phases over radix bits.

Legs, over N seeded random keys in [0, 2^30) with row-id payloads:
  histogram (bincount)          the bucket counts at 4, 8, 12 and 16 bits
                                ((key >> 5) & (2^bits - 1));
  partition pass (stable sort)  the radix family's pass (joins/radix.py) at
                                4 and 8 bits;
  sort+hist (K-A)               the block sort with bucket starts
                                (ops/kernels/compact.sort_hist, F1 = 16
                                buckets over the 30-bit domain);
  seg scatter (K-B)             the segment scatter of K-A's rows into F1
                                regions of c1 rows (compact._plan's
                                segments).

Each leg's time is the least of 3 calls after a warm-up, from CUDA events
on the card (perf_counter on the CPU), with nothing subtracted.

    python -m aqp_tpu_torch.experiments.partition_bench [--small] \\
        [--csv out.csv] [--sub 512] [--device cuda|cpu]

N = 2^26 (2^21 with --small).  The card is the default; --device cpu runs
every leg through the kernels' plain versions.
"""

from __future__ import annotations

import argparse

import torch

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.joins.radix import _partition_pass
from aqp_tpu_torch.ops.kernels.compact import (_plan, scatter_segments,
                                               sort_hist)
from aqp_tpu_torch.utils.timing import best_ms

CSV_HEADER = "phase,rows,bits,ms,mrows_per_s"
F1 = 16


def main(argv=None) -> list:
    """Run the legs; returns the rows (phase, rows, bits, ms, M rows/s)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--sub", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={name}", flush=True)
    N = (1 << 21) if args.small else (1 << 26)
    rows = []

    def rec(phase, bits, ms, n=N):
        mrows = n / ms / 1e3
        rows.append((phase, N, bits, ms, mrows))
        print(f"{phase:28s} N={N} bits={bits:2d}  {ms:8.2f} ms  "
              f"{mrows:9.1f} M rows/s", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    keys = torch.randint(0, 1 << 30, (N,), generator=gen, device=dev,
                         dtype=torch.int32)
    vals = torch.arange(N, dtype=torch.int32, device=dev)

    for bits in (4, 8, 12, 16):
        fanout = 1 << bits

        def hist(fanout=fanout):
            return torch.bincount((keys >> 5) & (fanout - 1),
                                  minlength=fanout)

        rec("histogram (bincount)", bits, best_ms(hist, dev))

    for bits in (4, 8):
        rec("partition pass (stable sort)", bits,
            best_ms(lambda: _partition_pass(keys, vals, 0, bits), dev))

    scale = torch.tensor(F1, dtype=torch.float32) / (1 << 30)
    sub = args.sub
    block = sub * 128
    n = (N // block) * block
    kk, vv = keys[:n], vals[:n]
    rec("sort+hist (K-A)", 4,
        best_ms(lambda: sort_hist(kk, vv, scale, sub, F1), dev), n)

    ks, ps, starts = sort_hist(kk, vv, scale, sub, F1)
    nb = n // block
    c1 = -(-int(n // 128 / F1 / 0.85) // sub) * sub
    soff, doff, sz, _ = _plan(nb, sub, starts, F1, c1)
    out_rows = F1 * c1 + 1
    rec("seg scatter (K-B)", 4, best_ms(lambda: scatter_segments(
        ks, ps, soff, doff, sz, nb * F1, out_rows), dev), n)

    if args.csv:
        with open(args.csv, "w") as f:
            f.write(CSV_HEADER + "\n")
            for phase, nrows, bits, ms, mrows in rows:
                f.write(f"{phase},{nrows},{bits},{ms:.3f},{mrows:.1f}\n")
        print(f"wrote {len(rows)} rows to {args.csv}")
    return rows


if __name__ == "__main__":
    main()

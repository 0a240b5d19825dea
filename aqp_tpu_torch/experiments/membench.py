"""Memory and primitive microbenchmarks (counterpart of
experiments/membench.py), the analog of the reference's WriteBench
(Scan-Micro-Benchmarks, shared/algorithms.hpp:8-41) and of the primitive
rates that decide the operators' design: stream bandwidth, gather and
scatter row rates, sort rates, cumsum, and the block sort
(ops/kernels/blocksort.sort_blocks, 512 rows of 128 a block).

Each row's time is the least of 3 calls after a warm-up, from CUDA events
on the card (perf_counter on the CPU), with nothing subtracted.

    python -m aqp_tpu_torch.experiments.membench [--small] \\
        [--csv out.csv] [--device cuda|cpu]

N = 2^24 and 2^27 (2^20 with --small): seeded random int32 keys and
values in [0, 2^30) and a random permutation.  The card is the default;
--device cpu runs the block sort's plain version.
"""

from __future__ import annotations

import argparse

import torch

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.ops.kernels.blocksort import sort_blocks
from aqp_tpu_torch.utils.timing import best_ms

CSV_HEADER = "benchmark,rows,ms,unit,value"


def _sort_pair(x, y):
    """y carried along a sort of x (the reference's two-array sort by its
    first array)."""
    v, i = torch.sort(x)
    return v, y[i]


def _scatter(x, perm):
    out = torch.zeros_like(x)
    out[perm] = x
    return out


def main(argv=None) -> list:
    """Run the benchmarks; returns the rows (benchmark, rows, ms, unit,
    value)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={name}", flush=True)
    ns = [1 << 20] if args.small else [1 << 24, 1 << 27]
    rows = []

    def rec(bench, n, ms, unit, value):
        rows.append((bench, n, ms, unit, value))
        print(f"{bench:24s} N={n:>10d}  {ms:8.2f} ms  {value:10.2f} {unit}",
              flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    for n in ns:
        keys = torch.randint(0, 1 << 30, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        vals = torch.randint(0, 1 << 30, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        perm = torch.randperm(n, generator=gen, device=dev)

        ms = best_ms(lambda: keys + 1, dev)
        rec("stream add (r+w)", n, ms, "GB/s", n * 8 / ms / 1e6)
        ms = best_ms(lambda: torch.cumsum(keys, 0, dtype=torch.int32), dev)
        rec("cumsum", n, ms, "GB/s", n * 8 / ms / 1e6)
        ms = best_ms(lambda: keys[perm], dev)
        rec("gather (perm)", n, ms, "Mrows/s", n / ms / 1e3)
        ms = best_ms(lambda: _scatter(keys, perm), dev)
        rec("scatter (unique)", n, ms, "Mrows/s", n / ms / 1e3)
        ms = best_ms(lambda: torch.sort(keys), dev)
        rec("sort i32", n, ms, "Mrows/s", n / ms / 1e3)
        ms = best_ms(lambda: _sort_pair(keys, vals), dev)
        rec("sort pair i32", n, ms, "Mrows/s", n / ms / 1e3)
        ms = best_ms(lambda: sort_blocks(keys, vals, sub=512), dev)
        rec("block sort", n, ms, "Mrows/s", n / ms / 1e3)
        del keys, vals, perm

    if args.csv:
        with open(args.csv, "w") as f:
            f.write(CSV_HEADER + "\n")
            for bench, n, ms, unit, value in rows:
                f.write(f"{bench},{n},{ms:.3f},{unit},{value:.2f}\n")
        print(f"wrote {len(rows)} rows to {args.csv}")
    return rows


if __name__ == "__main__":
    main()

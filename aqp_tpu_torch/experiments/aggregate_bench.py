"""Group-by throughput against the number of groups (counterpart of
experiments/aggregate_bench.py): n rows, group counts from 2^6 to 2^24,
each with capacity max(256, 2 x groups).

The engine is picked as the reference picks it: the routed aggregate
(ops/kernels/aggpipe.groupby_aggregate_routed_auto: rho3's K1 and K2
range-routed, K3AGG, the segment scatters) where its num_groups fits the
capacity, else the sort-based ops/aggregate.groupby_aggregate; the engine
column says which served ("routed" or "xla", the reference's names).  Only
a reported overflow (num_groups poisoned past the capacity) selects the
sort-based engine: a call that raises ends the run.  The routed engine is
tried on the CPU too, where the kernels' plain versions serve it.  A time
is the mean of --reps calls after a warm-up (CUDA events on the card).

Keys are uniform in [0, groups) from a torch.Generator seeded with the
group count's exponent, payloads uniform in [0, 2^30) from seed 1 (the
reference draws both with jax.random under the same seeds: other bits).

    python -m aqp_tpu_torch.experiments.aggregate_bench [--small] \\
        [--csv out.csv] [--reps 3] [--device cuda|cpu]

n = 2^26 (2^20 with --small).  The card is the default.  Nothing is
written without --csv.
"""

from __future__ import annotations

import argparse

import torch

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.ops.aggregate import groupby_aggregate
from aqp_tpu_torch.ops.kernels.aggpipe import groupby_aggregate_routed_auto
from aqp_tpu_torch.utils.timing import mean_ms

CSV_HEADER = "rows,cardinality,live_groups,engine,ms,mrows_per_s"
ROWS_LOG2 = {False: 26, True: 20}
EXPONENTS = {False: (6, 10, 14, 17, 20, 22, 24), True: (4, 8, 12)}


def capacity(groups: int) -> int:
    return max(256, 2 * groups)


def draw(n: int, bound: int, seed: int, device) -> torch.Tensor:
    """n int32 values uniform in [0, bound) from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, bound, (n,), generator=gen, device=device,
                         dtype=torch.int32)


def main(argv=None) -> list:
    """Run the sweep; returns the rows (rows, cardinality, live_groups,
    engine, ms, M rows/s)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={name}", flush=True)
    n = 1 << ROWS_LOG2[args.small]
    print(f"n={n}", flush=True)
    pay = draw(n, 1 << 30, 1, dev)
    rows = []
    for e in EXPONENTS[args.small]:
        k = 1 << e
        if k > n:
            continue
        key = draw(n, k, e, dev)
        cap = capacity(k)
        g = groupby_aggregate_routed_auto(key, pay, cap, device=dev)
        eng, engine = (("routed", groupby_aggregate_routed_auto)
                       if int(g.num_groups) <= cap
                       else ("xla", groupby_aggregate))
        ms, g = mean_ms(lambda: engine(key, pay, cap, device=dev), dev,
                        args.reps)
        ng = int(g.num_groups)
        if ng > cap:
            raise RuntimeError(f"{eng} aggregate of 2^{e} groups: "
                               f"{ng} groups past capacity {cap}")
        mrows = n / ms / 1e3
        print(f"groups=2^{e:<2d} ({ng:>8d} live, {eng:6s})  "
              f"{ms:8.1f} ms  {mrows:8.1f} M rows/s", flush=True)
        rows.append((n, k, ng, eng, round(ms, 2), round(mrows, 1)))
        del key, g
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    if args.csv:
        with open(args.csv, "w") as f:
            f.write(CSV_HEADER + "\n")
            for r in rows:
                f.write(",".join(map(str, r)) + "\n")
        print(f"wrote {len(rows)} rows to {args.csv}")
    return rows


if __name__ == "__main__":
    main()

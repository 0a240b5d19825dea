"""Command-line layer (counterpart of aqp_tpu/__main__.py): the
reference's four binaries as subcommands, on one CUDA device.

    python -m aqp_tpu_torch join  -a RHO -r 13107200 -s 52428800 [-z skew]
                                  [-l selectivity] [-m] [--reps N]
    python -m aqp_tpu_torch tpch  -q 3 --scale 1.0 -a RHO [--data DIR]
                                  [--fused]
    python -m aqp_tpu_torch scan  --mode bitvector --rows 268435456
                                  --selectivity 10
    python -m aqp_tpu_torch matrix --algs RHO,PHT --sizes 1048576x4194304
                                   [--csv out.csv]

Each prints the metric contract (`Timings.print_contract`'s lines, then
one JSON line with the reference's keys; `scan` the JSON line alone;
`matrix` the CSV).  `--profile DIR` traces the measured section with
torch.profiler and adds `device_total_s` and `profile_dir` to the JSON
line.  Every subcommand runs on `--device` (default cuda, which needs a
CUDA device; `--device cpu` runs the kernels' plain versions on the CPU).
`join --key64` draws R and S as int64 (the reference's KEY_8B), which every
join name serves without a kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def _profile_ctx(args, device):
    """(context manager, logdir|None) for --profile: a torch.profiler trace
    around the measured section (utils/profiler.py)."""
    logdir = getattr(args, "profile", None)
    if logdir:
        from aqp_tpu_torch.utils import profiler

        return profiler.trace(logdir, device=device), logdir
    return contextlib.nullcontext(), None


def _profile_extras(logdir):
    if not logdir:
        return {}
    from aqp_tpu_torch.utils import profiler

    rep = profiler.parse_trace(logdir)
    print(f"# profile: device {rep.device_total_s*1e3:.2f} ms over "
          f"{sum(rep.per_program_calls.values())} kernel launches "
          f"-> {logdir}", file=sys.stderr)
    return {"device_total_s": round(rep.device_total_s, 6),
            "profile_dir": logdir}


def _dataset_sizes(name: str):
    # the reference's predefined datasets (rows of 8-byte tuples)
    if name == "cache-fit":
        return 10 * (1 << 20) // 8, 40 * (1 << 20) // 8
    if name == "cache-exceed":
        return 100 * (1 << 20) // 8, 400 * (1 << 20) // 8
    if name == "L":
        return 50_000_000, 200_000_000
    raise SystemExit(f"unknown dataset {name} (cache-fit|cache-exceed|L)")


def cmd_join(args, dev):
    from aqp_tpu_torch.config import JoinConfig
    from aqp_tpu_torch.data import (
        create_relation_fk,
        create_relation_fk_sel,
        create_relation_pk,
        create_relation_zipf,
    )
    from aqp_tpu_torch.joins.api import run_join
    from aqp_tpu_torch.utils.timing import hard_sync

    nr, ns = (args.r, args.s) if args.x is None else _dataset_sizes(args.x)
    cfg = JoinConfig(
        materialize=args.m,
        radix_bits=args.radix_bits,
        passes=args.passes,
        use_pallas=not args.no_pallas,
        key64=args.key64,
    )
    dtype = cfg.key_dtype
    relR = create_relation_pk(nr, seed=args.seed_r, dtype=dtype, device=dev)
    if args.z:
        relS = create_relation_zipf(ns, nr, args.z, seed=args.seed_s,
                                    dtype=dtype, device=dev)
    elif args.l is not None:
        relS = create_relation_fk_sel(ns, nr, args.l, seed=args.seed_s,
                                      dtype=dtype, device=dev)
    else:
        relS = create_relation_fk(ns, nr, seed=args.seed_s, dtype=dtype,
                                  device=dev)
    hard_sync((relR.key, relS.key))
    best = None
    ctx, logdir = _profile_ctx(args, dev)
    with ctx:
        for rep in range(args.reps):
            result, t = run_join(relR, relS, args.a, cfg, device=dev)
            if best is None or t.total < best.total:
                best = t
            if not args.quiet:
                print(f"# rep {rep}: {t.mrows_per_s:.1f} M rows/s",
                      file=sys.stderr)
    best.print_contract()
    print(best.json_line(alg=args.a, size_r=nr, size_s=ns,
                         **_profile_extras(logdir)))


def cmd_tpch(args, dev):
    from aqp_tpu_torch.queries import (
        generate_tpch_tables,
        tpch_q3,
        tpch_q10,
        tpch_q12,
        tpch_q19,
    )

    if args.data:
        from aqp_tpu_torch.data import tpch_loader as L

        l = L.load_lineitem(args.data, device=dev)
        o = L.load_orders(args.data, device=dev)
        c = L.load_customer(args.data, device=dev)
        p = L.load_part(args.data, device=dev)
        n = L.load_nation(args.data, device=dev)
    else:
        l, o, c, p, n = generate_tpch_tables(scale=args.scale, device=dev)
    if args.fused:
        from aqp_tpu_torch.queries import fused as FU
        from aqp_tpu_torch.utils.timing import Timings

        fused_plans = {
            3: (lambda: FU.tpch_q3_fused(c, o, l),
                c.num_tuples + o.num_tuples + l.num_tuples),
            10: (lambda: FU.tpch_q10_fused(c, o, l, n),
                 c.num_tuples + o.num_tuples + l.num_tuples + n.num_tuples),
            12: (lambda: FU.tpch_q12_fused(l, o),
                 l.num_tuples + o.num_tuples),
            19: (lambda: FU.tpch_q19_fused(l, p),
                 l.num_tuples + p.num_tuples),
        }
        fn, rows_in = fused_plans[args.q]
        m, ok = fn()  # first call + correctness
        assert bool(ok), "fused capacity bound exceeded; rerun without --fused"
        best = 1e30
        ctx, logdir = _profile_ctx(args, dev)
        with ctx:
            for _ in range(args.reps):
                t0 = time.perf_counter()
                m, ok = fn()
                int(m)
                best = min(best, time.perf_counter() - t0)
        t = Timings(phases={"total": best}, rows_in=rows_in, matches=int(m))
        t.print_contract()
        print(t.json_line(query=f"Q{args.q}", alg="fused", scale=args.scale,
                          **_profile_extras(logdir)))
        return
    plans = {
        3: lambda: tpch_q3(c, o, l, algorithm=args.a),
        10: lambda: tpch_q10(c, o, l, n, algorithm=args.a),
        12: lambda: tpch_q12(l, o, algorithm=args.a),
        19: lambda: tpch_q19(l, p, algorithm=args.a),
    }
    if args.q not in plans:
        raise SystemExit(f"query must be one of {sorted(plans)}")
    best = None
    ctx, logdir = _profile_ctx(args, dev)
    with ctx:
        for _ in range(args.reps):
            res = plans[args.q]()
            if best is None or res.timings.total < best.timings.total:
                best = res
    best.timings.print_contract()
    print(best.timings.json_line(query=f"Q{args.q}", alg=args.a,
                                 scale=args.scale,
                                 **_profile_extras(logdir)))


def cmd_scan(args, dev):
    import torch

    from aqp_tpu_torch.ops import scan as S
    from aqp_tpu_torch.utils.timing import hard_sync

    n = args.rows
    col = (torch.arange(n, dtype=torch.int32, device=dev) & 255).to(
        torch.uint8)
    hi = min(255, round(args.selectivity / 100.0 * 255))
    lo = 0
    hard_sync(col)
    mode = args.mode
    cap = max(8, int(n * min(1.0, args.selectivity / 100.0 * 1.2)))
    fns = {
        "count": lambda: S.scan_count(col, lo, hi, device=dev),
        "sum": lambda: S.scan_sum(col, lo, hi, device=dev),
        "bitvector": lambda: S.scan_bitvector(col, lo, hi, device=dev),
        "index": lambda: S.scan_index(col, lo, hi, cap, device=dev),
        "values": lambda: S.scan_values(col, lo, hi, cap, device=dev),
        "dict": lambda: S.scan_dict(
            col, torch.arange(256, dtype=torch.int64, device=dev) * 7,
            lo, hi, cap, device=dev),
    }
    if mode not in fns:
        raise SystemExit(f"mode must be one of {sorted(fns)}")
    hard_sync(fns[mode]())
    best = float("inf")
    ctx, logdir = _profile_ctx(args, dev)
    with ctx:
        for _ in range(args.reps):
            t0 = time.perf_counter()
            hard_sync(fns[mode]())
            best = min(best, time.perf_counter() - t0)
    gbs = n / best / 1e9
    print(json.dumps({"mode": mode, "rows": n, "selectivity": args.selectivity,
                      "seconds": round(best, 6), "gb_per_s": round(gbs, 2),
                      **_profile_extras(logdir)}))


def cmd_matrix(args, dev):
    from aqp_tpu_torch.harness.runner import (ExperimentConfig,
                                              rows_to_csv, run_experiments)

    sizes = []
    for spec in args.sizes.split(","):
        r, s = spec.lower().split("x")
        sizes.append((int(r), int(s)))
    cfg = ExperimentConfig(
        algorithms=tuple(args.algs.split(",")),
        sizes=tuple(sizes),
        skews=(tuple(float(z) for z in args.skews.split(","))
               if args.skews else (None,)),
        materialize=((True, False) if args.materialize == "both"
                     else (args.materialize == "1",)),
        reps=args.reps,
        profile_dir=args.profile,
        device=str(dev),
    )
    rows = run_experiments(cfg)
    if args.csv:
        rows_to_csv(rows, args.csv, append=args.append)
        print(f"# wrote {len(rows)} rows to {args.csv}", file=sys.stderr)


def _device_arg(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="aqp_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    j = sub.add_parser("join", help="single join run (native.cpp analog)")
    j.add_argument("-a", default="RHO", help="algorithm name (joins.cpp table)")
    j.add_argument("-r", type=int, default=1 << 21, help="|R| rows")
    j.add_argument("-s", type=int, default=1 << 21, help="|S| rows")
    j.add_argument("-x", default=None,
                   help="predefined dataset: cache-fit|cache-exceed|L")
    j.add_argument("-z", type=float, default=0.0, help="Zipf skew exponent")
    j.add_argument("-l", type=float, default=None, help="selectivity percent")
    j.add_argument("-m", action="store_true", help="materialize output")
    j.add_argument("--radix-bits", type=int, default=None)
    j.add_argument("--passes", type=int, default=None)
    j.add_argument("--no-pallas", action="store_true",
                   help="no kernel pipeline (RHO: the radix frame)")
    j.add_argument("--key64", action="store_true",
                   help="64-bit keys and payloads (KEY_8B analog)")
    j.add_argument("--reps", type=int, default=3)
    j.add_argument("--seed-r", type=int, default=11111)
    j.add_argument("--seed-s", type=int, default=22222)
    j.add_argument("--quiet", action="store_true")
    j.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace (PerfEvent analog)")
    _device_arg(j)
    j.set_defaults(fn=cmd_join)

    t = sub.add_parser("tpch", help="TPC-H query run (TpcHApp.cpp analog)")
    t.add_argument("-q", type=int, required=True, help="query: 3|10|12|19")
    t.add_argument("-a", default="RHO")
    t.add_argument("--scale", type=float, default=0.1)
    t.add_argument("--data", default=None, help="binary column dir (scale###)")
    t.add_argument("--reps", type=int, default=3)
    t.add_argument("--fused", action="store_true",
                   help="fused plan with bounded buffers (serving path)")
    t.add_argument("--profile", default=None, metavar="DIR")
    _device_arg(t)
    t.set_defaults(fn=cmd_tpch)

    s = sub.add_parser("scan",
                       help="column-scan microbenchmark (SimdScanMulti analog)")
    s.add_argument("--mode", default="bitvector")
    s.add_argument("--rows", type=int, default=1 << 26)
    s.add_argument("--selectivity", type=float, default=10.0)
    s.add_argument("--reps", type=int, default=5)
    s.add_argument("--profile", default=None, metavar="DIR")
    _device_arg(s)
    s.set_defaults(fn=cmd_scan)

    m = sub.add_parser("matrix",
                       help="experiment matrix -> CSV (runner.py analog)")
    m.add_argument("--algs", default="RHO")
    m.add_argument("--sizes", default="1048576x4194304")
    m.add_argument("--skews", default=None)
    m.add_argument("--materialize", default="0", choices=("0", "1", "both"))
    m.add_argument("--reps", type=int, default=3)
    m.add_argument("--csv", default=None)
    m.add_argument("--append", action="store_true")
    m.add_argument("--profile", default=None, metavar="DIR",
                   help="trace each rep; adds device_total_s rows")
    _device_arg(m)
    m.set_defaults(fn=cmd_matrix)

    args = p.parse_args(argv)
    from aqp_tpu_torch import resolve_device

    args.fn(args, resolve_device(args.device))


if __name__ == "__main__":
    main()

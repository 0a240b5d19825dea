"""Scan configuration spectrum (counterpart of experiments/scan_bench.py),
the analog of the reference's SimdScanMulti (Scan-Micro-Benchmarks,
App/types.hpp:106-189): mode x entries x selectivity x preload, one CSV
row each, feeding the paper's write-rate.csv and scale-up.csv families.

  mode         the six scan modes (count, sum, bitvector, index, values,
               dict), each in two engines: "pallas", the hand-written
               kernels (ops/kernels/scan.py's scan_*_pallas: B7 for count
               and sum, B8 for bitvector, the window compactor B5 with the
               segment scatter B6 for index, values and dict), and "xla",
               plain ops/scan.py (count, sum and bitvector through the same
               B7 / B8 wrappers, index, values and dict a dense fixed
               capacity);
  entries      a size sweep up to 2^30 rows;
  selectivity  the predicate's range width [0, hi];
  preload      residency: "resident" re-scans a column on the card,
               "streamed" copies the host column to the card on each scan,
               "streamed_pipelined" runs ops/scan.scan_count_streamed
               (chunks of 2^25 rows, copy i + 1 under scan i).  The host
               column is pinned on a card.

Families (each --csv-dir/<file>): selectivity -> scan-selectivity.csv,
scaleup -> scan-scale-up.csv, residency -> scan-residency.csv.  A time is
the mean of --reps calls after a warm-up (CUDA events on the card).  The
pallas write modes size their output by the selectivity (1.6x it + 0.2%);
where that bound reports overflow, the row is measured with the full-size
output (n/128 rows of 128), the reference's overflow channel.  A call
that raises ends the run (the reference's driver logged and skipped it).
Below one block of 4,096 x 128 rows the B7 / B8 entries take the column
as one block (the reference's call raises there).

    python -m aqp_tpu_torch.experiments.scan_bench [--small] \\
        [--family all|selectivity|scaleup|residency] [--reps 5] \\
        [--csv-dir DIR] [--device cuda|cpu]

The card is the default; --device cpu runs the kernels' plain versions
(both engines).  Nothing is written without --csv-dir.
"""

from __future__ import annotations

import argparse
import sys

import torch

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.ops import scan as xs
from aqp_tpu_torch.ops.kernels import scan as ps
from aqp_tpu_torch.utils.timing import mean_ms

LANES = 128
CSV_HEADER = ("family,mode,engine,rows,selectivity,residency,ms,read_gb_s,"
              "write_gb_s")
MODES = ("count", "sum", "bitvector", "index", "values", "dict")
ENGINES = ("pallas", "xla")
SELECTIVITIES = (1.0, 10.0, 25.0, 50.0, 75.0, 100.0)
SELECTIVITY_ROWS = {
    False: {"count": 1 << 30, "sum": 1 << 30, "bitvector": 1 << 30,
            "index": 1 << 29, "values": 1 << 28, "dict": 1 << 28},
    True: {m: 1 << 20 for m in MODES},
}
XLA_ROWS = 1 << 26           # the xla engine's columns at full size
SCALEUP_ROWS = {False: (1 << 17, 1 << 20, 1 << 23, 1 << 26, 1 << 29,
                        1 << 30),
                True: (1 << 17, 1 << 20)}
RESIDENCY_ROWS = {False: 1 << 28, True: 1 << 20}
STREAM_CHUNK = 1 << 25


def log(msg):
    print(f"[scan] {msg}", file=sys.stderr, flush=True)


def _sub(n: int) -> int:
    """B7's / B8's block rows for an n-row column: the reference's 4,096,
    or the whole column below one block."""
    return min(ps.SUB, max(1, n // LANES))


def make_fns(col, n, engine, cap_rows, dict_lo, dict_hi, device):
    """mode -> (fn(lo, hi[, sel]) -> out, fetch(out) -> int, write bytes a
    qualifying row)."""
    if engine == "pallas":
        sub = _sub(n)
        return {
            "count": (lambda lo, hi: ps.scan_count_pallas(
                col, lo, hi, sub=sub, device=device), int, 0),
            "sum": (lambda lo, hi: ps.scan_sum_pallas(
                col, lo, hi, sub=sub, device=device), int, 0),
            "bitvector": (lambda lo, hi: ps.scan_bitvector_pallas(
                col, lo, hi, sub=sub, device=device),
                lambda o: int(o[0]), 0.125),
            "index": (lambda lo, hi, sel=None: ps.scan_index_pallas(
                col, lo, hi, cap_rows, sel_hint=sel, device=device),
                lambda o: int(o[1]), 4),
            "values": (lambda lo, hi, sel=None: ps.scan_values_pallas(
                col, lo, hi, cap_rows, sel_hint=sel, device=device),
                lambda o: int(o[2]), 8),
            "dict": (lambda lo, hi, sel=None: ps.scan_dict_pallas(
                col, dict_lo, dict_hi, lo, hi, cap_rows, sel_hint=sel,
                device=device), lambda o: int(o[3]), 12),
        }
    cap = cap_rows * LANES

    def xla_dict(lo, hi):
        # 64-bit dictionary values as two int32 planes, as the reference's
        # xla engine decodes them (the pallas engine's layout too)
        ids, cnt = xs.scan_index(col, lo, hi, cap, device=device)
        codes = col[ids.long()].long()
        return dict_lo[codes], dict_hi[codes], cnt

    return {
        "count": (lambda lo, hi: xs.scan_count(col, lo, hi, device=device),
                  int, 0),
        "sum": (lambda lo, hi: xs.scan_sum(col, lo, hi, device=device),
                int, 0),
        "bitvector": (lambda lo, hi: xs.scan_bitvector(col, lo, hi,
                                                       device=device),
                      lambda o: int(o[0]), 0.125),
        "index": (lambda lo, hi: xs.scan_index(col, lo, hi, cap,
                                               device=device),
                  lambda o: int(o[1]), 4),
        "values": (lambda lo, hi: xs.scan_values(col, lo, hi, cap,
                                                 device=device),
                   lambda o: int(o[1]), 4),
        "dict": (xla_dict, lambda o: int(o[2]), 8),
    }


def sel_bounds(sel: float) -> tuple:
    """Predicate [0, hi] over a uniform 0..255 column ~= sel% qualifying."""
    return 0, max(0, min(255, round(sel / 100.0 * 256) - 1))


def make_col(n: int, device) -> torch.Tensor:
    """The reference's column: row i holds i & 255."""
    return (torch.arange(n, dtype=torch.int32, device=device) & 255).to(
        torch.uint8)


def dict_planes(device) -> tuple:
    d = torch.arange(256, dtype=torch.int32, device=device) * 7
    return d, d + 1


def _takes_sel(mode: str, engine: str) -> bool:
    return engine == "pallas" and mode in ("index", "values", "dict")


def run_config(fns, mode, engine, sel, n, reps, device):
    """(s a call, read GB/s, write GB/s, the fetched answer) of one
    configuration."""
    fn, fetch, wb = fns[mode]
    lo, hi = sel_bounds(sel)
    if _takes_sel(mode, engine):
        ms, out = mean_ms(lambda: fn(lo, hi, sel / 100.0), device, reps)
    else:
        ms, out = mean_ms(lambda: fn(lo, hi), device, reps)
    t = ms / 1e3
    read_gbs = n / t / 1e9  # 1 byte/row
    write_gbs = (n * (sel / 100.0) * wb) / t / 1e9 if wb else 0.0
    return t, read_gbs, write_gbs, fetch(out)


def family_selectivity(small, reps, rows, device):
    n_mode = SELECTIVITY_ROWS[small]
    dlo, dhi = dict_planes(device)
    for engine in ENGINES:
        for mode in MODES:
            n = n_mode[mode]
            if engine == "xla" and not small:
                n = min(n, XLA_ROWS)
            col = make_col(n, device)
            fns = make_fns(col, n, engine, n // LANES, dlo, dhi, device)
            for sel in SELECTIVITIES:
                fns_m = fns
                if _takes_sel(mode, engine):
                    # selectivity-scaled output; a reported overflow of
                    # that bound sends the row to the full-size output
                    capf = min(1.0, sel / 100.0 * 1.6 + 0.002)
                    capr = max(256, int(n * capf) // LANES)
                    fns_m = make_fns(col, n, engine, capr, dlo, dhi, device)
                    lo_, hi_ = sel_bounds(sel)
                    if int(fns_m[mode][0](lo_, hi_, sel / 100.0)[-1]) != 0:
                        log(f"sel {mode} sel={sel}: scaled cap overflowed"
                            " - using full-size buffer")
                        fns_m = fns
                t, r, w, got = run_config(fns_m, mode, engine, sel, n, reps,
                                          device)
                rows.append(("selectivity", mode, engine, n, sel,
                             "resident", round(t * 1e3, 3), round(r, 2),
                             round(w, 2), got))
                log(f"sel {engine}:{mode} n={n} sel={sel:5.1f}% "
                    f"read {r:7.2f} GB/s write {w:6.2f} GB/s")
            del col, fns, fns_m


def family_scaleup(small, reps, rows, device):
    dlo, dhi = dict_planes(device)
    for n in SCALEUP_ROWS[small]:
        col = make_col(n, device)
        for engine in ENGINES:
            fns = make_fns(col, n, engine, n // LANES, dlo, dhi, device)
            modes = ("count", "values") if n < (1 << 29) else ("count",)
            for mode in modes:  # one compute-, one write-bound
                t, r, w, got = run_config(fns, mode, engine, 10.0, n, reps,
                                          device)
                rows.append(("scaleup", mode, engine, n, 10.0, "resident",
                             round(t * 1e3, 3), round(r, 2), round(w, 2),
                             got))
                log(f"scaleup {engine}:{mode} n={n:>10d} read {r:7.2f} "
                    "GB/s")
        del col


def family_residency(small, reps, rows, device):
    """preload = true / false: a re-scan of the column on the card against
    a copy of the host column to the card on every scan."""
    n = RESIDENCY_ROWS[small]
    host = make_col(n, "cpu")
    if device.type == "cuda":
        host = host.pin_memory()
    dlo, dhi = dict_planes(device)
    cap_rows = n // LANES
    engine = "pallas"
    col_dev = host.to(device)
    fns = make_fns(col_dev, n, engine, cap_rows, dlo, dhi, device)
    lo, hi = sel_bounds(10.0)
    for mode in ("count", "index"):
        t, r, w, got = run_config(fns, mode, engine, 10.0, n, reps, device)
        rows.append(("residency", mode, engine, n, 10.0, "resident",
                     round(t * 1e3, 3), round(r, 2), round(w, 2), got))
        fn, fetch, wb = fns[mode]

        def streamed_mono(mode=mode):
            """one whole copy of the column to the card a scan"""
            c = host.to(device)
            return make_fns(c, n, engine, cap_rows, dlo, dhi,
                            device)[mode][0](lo, hi)

        variants = [("streamed", streamed_mono, fetch)]
        if mode == "count":
            variants.append(("streamed_pipelined", lambda: (
                xs.scan_count_streamed(host, lo, hi, chunk=STREAM_CHUNK,
                                       device=device)), int))
        for vname, vfn, vfetch in variants:
            ms, out = mean_ms(vfn, device, max(1, reps // 2))
            t = ms / 1e3
            r = n / t / 1e9
            w = (n * 0.1 * wb) / t / 1e9 if wb else 0.0
            rows.append(("residency", mode, engine, n, 10.0, vname,
                         round(t * 1e3, 3), round(r, 2), round(w, 2),
                         vfetch(out)))
            log(f"residency {mode} {vname}: {r:.2f} GB/s")


FAMILIES = {
    "selectivity": (family_selectivity, "scan-selectivity.csv"),
    "scaleup": (family_scaleup, "scan-scale-up.csv"),
    "residency": (family_residency, "scan-residency.csv"),
}


def main(argv=None) -> dict:
    """Run the families; returns family -> its rows: the CSV's columns,
    then the answer the timed calls fetched (the count, the sum, the
    bitvector's first byte, or the qualifying rows' count)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--family", default="all",
                    choices=["all", *FAMILIES])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--csv-dir", default=None,
                    help="write the families' CSVs here (nothing is "
                         "written without)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={name}", flush=True)
    out = {}
    todo = list(FAMILIES) if args.family == "all" else [args.family]
    for fam in todo:
        fn, csv = FAMILIES[fam]
        rows = out[fam] = []
        fn(args.small, args.reps, rows, dev)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if args.csv_dir:
            path = f"{args.csv_dir}/{csv}"
            with open(path, "w") as f:
                f.write(CSV_HEADER + "\n")
                for r in rows:
                    f.write(",".join(map(str, r[:9])) + "\n")
            print(f"wrote {path} ({len(rows)} rows)")
    return out


if __name__ == "__main__":
    main()

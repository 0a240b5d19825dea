"""The join-sweep drivers' shared front end: join_overview, skew,
selectivity and scaling are each an ExperimentConfig matrix (or two) over
harness.run_experiments_pipelined, written with harness.rows_to_csv in the
long format.

    python -m aqp_tpu_torch.experiments.<driver> [--small] \\
        [--csv out.csv] [--device cuda|cpu]

The card is the default (--device cpu runs the kernels' plain versions).
Nothing is written without --csv, so the JAX package's results/*.csv stay
as they are.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.harness import (ExperimentConfig, rows_to_csv,
                                   run_experiments_pipelined)


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--small", action="store_true",
                    help="the drivers' small sizes")
    ap.add_argument("--csv", default=None,
                    help="write the rows here (nothing is written without)")
    ap.add_argument("--device", default="cuda")
    return ap


def run(cfgs: Sequence[ExperimentConfig], args,
        backend: Optional[str] = None, append: bool = False) -> List[dict]:
    """Run each matrix, print one line a configuration and write --csv
    (appended to with `append`); returns the rows."""
    dev = resolve_device(args.device)
    rows: List[dict] = []
    for cfg in cfgs:
        rows += run_experiments_pipelined(cfg, backend=backend)
    for r in rows:
        if r["rep"] == 0 and r["measurement"] in ("throughput_mrows",
                                                  "error"):
            print(f"{r['backend']} {r['alg']} {r['size_r']}x{r['size_s']} "
                  f"skew={r['skew']} sel={r['selectivity']} "
                  f"{r['measurement']}={r['value']}", flush=True)
    if args.csv:
        rows_to_csv(rows, args.csv, append=append)
        print(f"wrote {len(rows)} rows to {args.csv} "
              f"(device {dev.type})", flush=True)
    return rows

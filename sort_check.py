"""Repeat chip_smoke.py's block-sort exactness checks on one CUDA card.

    python3 sort_check.py [--rounds R] [--blocks 3 1 9] [--fs 1 16 127]

Each round runs chip_smoke.check_sort_kernels with new seeds: sort_blocks
(B13) and sort_hist (B12, at each F of --fs) against their plain versions
at sub = 128, 256, 512 and 1024, on every case of phase 12 (sort_cases at
the first --blocks count, design_cases at each of the others).  Round 0
uses phase 12's own seeds.  Any difference exits non-zero.  Under
compute-sanitizer, one block a case keeps the run short:

    compute-sanitizer --tool racecheck python3 sort_check.py --rounds 1 \\
        --blocks 1 1 --fs 16
"""

import argparse
import faulthandler
import sys
import time

import torch

import chip_smoke


def main(argv=None) -> int:
    faulthandler.cancel_dump_traceback_later()   # chip_smoke's watchdog
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--blocks", type=int, nargs="+", default=[3, 1, 9])
    ap.add_argument("--fs", type=int, nargs="+", default=[1, 16, 127])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sort_check: no CUDA device is available", file=sys.stderr)
        return 2
    for r in range(args.rounds):
        t0 = time.perf_counter()
        chip_smoke.check_sort_kernels(seed=1000 * r, blocks=args.blocks,
                                      fs=args.fs)
        torch.cuda.synchronize()
        print(f"round {r}: sort_blocks and sort_hist exact in every case "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

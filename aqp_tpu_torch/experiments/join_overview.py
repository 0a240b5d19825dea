"""Join-algorithm overview (counterpart of experiments/join_overview.py):
every join name but NL at 13,107,200 x 52,428,800 (the cache-exceed class),
NL at 2^18 x 2^20, 3 pipelined calls each; --key64 runs RHO, PHT, MWAY and
INL on int64 relations instead, labelled `<device>_k64` (the reference's
tpu_k64 rows), appended to --csv.

    python -m aqp_tpu_torch.experiments.join_overview [--small] [--key64] \\
        [--csv out.csv] [--device cuda|cpu]
"""

from __future__ import annotations

from typing import List

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.experiments import sweep
from aqp_tpu_torch.harness import ExperimentConfig
from aqp_tpu_torch.joins.api import JOIN_ALGORITHMS


def _size(small: bool):
    return (1 << 16, 1 << 18) if small else (13_107_200, 52_428_800)


def configs(small: bool = False, device: str = "cuda"
            ) -> List[ExperimentConfig]:
    """The overview's two matrices: every name but NL, then NL (the
    O(|R| * |S|) baseline) at its own small size."""
    return [
        ExperimentConfig(algorithms=sorted(set(JOIN_ALGORITHMS) - {"NL"}),
                         sizes=[_size(small)], reps=3, device=device),
        ExperimentConfig(algorithms=["NL"],
                         sizes=[(1 << 14, 1 << 16) if small
                                else (1 << 18, 1 << 20)],
                         reps=3, device=device),
    ]


def key64_configs(small: bool = False, device: str = "cuda"
                  ) -> List[ExperimentConfig]:
    """The key64 rows: RHO, PHT, MWAY and INL on int64 relations."""
    return [ExperimentConfig(algorithms=["RHO", "PHT", "MWAY", "INL"],
                             sizes=[_size(small)], reps=3, key64=True,
                             device=device)]


def main(argv=None) -> list:
    ap = sweep.parser(__doc__.splitlines()[0])
    ap.add_argument("--key64", action="store_true",
                    help="the int64 rows (appended to --csv)")
    args = ap.parse_args(argv)
    if args.key64:
        dev = resolve_device(args.device)
        return sweep.run(key64_configs(args.small, args.device), args,
                         backend=f"{dev.type}_k64", append=True)
    return sweep.run(configs(args.small, args.device), args)


if __name__ == "__main__":
    main()

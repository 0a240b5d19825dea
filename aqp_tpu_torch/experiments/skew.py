"""Zipf skew study (counterpart of experiments/skew.py): RHO, PHT and PSM
at 13,107,200 x 52,428,800 over Zipf z in {uniform, 0.5, 1.0, 1.25, 1.5},
3 pipelined calls each.

    python -m aqp_tpu_torch.experiments.skew [--small] \\
        [--csv out.csv] [--device cuda|cpu]
"""

from __future__ import annotations

from aqp_tpu_torch.experiments import sweep
from aqp_tpu_torch.harness import ExperimentConfig


def config(small: bool = False, device: str = "cuda") -> ExperimentConfig:
    size = (1 << 16, 1 << 18) if small else (13_107_200, 52_428_800)
    return ExperimentConfig(algorithms=["RHO", "PHT", "PSM"], sizes=[size],
                            skews=[None, 0.5, 1.0, 1.25, 1.5], reps=3,
                            device=device)


def main(argv=None) -> list:
    args = sweep.parser(__doc__.splitlines()[0]).parse_args(argv)
    return sweep.run([config(args.small, args.device)], args)


if __name__ == "__main__":
    main()

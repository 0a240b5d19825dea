"""Join-selectivity sweep (counterpart of experiments/selectivity.py, the
reference's `-l` experiments): RHO and PHT at 13,107,200 x 52,428,800 with
1, 10, 25, 50, 75 and 100% of S's rows matching, 3 pipelined calls each.

    python -m aqp_tpu_torch.experiments.selectivity [--small] \\
        [--csv out.csv] [--device cuda|cpu]
"""

from __future__ import annotations

from aqp_tpu_torch.experiments import sweep
from aqp_tpu_torch.harness import ExperimentConfig


def config(small: bool = False, device: str = "cuda") -> ExperimentConfig:
    size = (1 << 16, 1 << 18) if small else (13_107_200, 52_428_800)
    return ExperimentConfig(algorithms=["RHO", "PHT"], sizes=[size],
                            selectivities=[1.0, 10.0, 25.0, 50.0, 75.0,
                                           100.0],
                            reps=3, device=device)


def main(argv=None) -> list:
    args = sweep.parser(__doc__.splitlines()[0]).parse_args(argv)
    return sweep.run([config(args.small, args.device)], args)


if __name__ == "__main__":
    main()

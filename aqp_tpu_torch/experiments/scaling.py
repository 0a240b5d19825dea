"""|R| scaling study (counterpart of experiments/scaling.py): RHO and PHT
with |R| = 2^17, 2^20, 2^23, 2^25, 2^27 and 2^29 at |S| = 52,428,800, 3
pipelined calls each, payloads aliased to the keys (keys-only runs never
read them; it halves the device memory of the 2^29 point).

    python -m aqp_tpu_torch.experiments.scaling [--small] \\
        [--csv out.csv] [--device cuda|cpu]
"""

from __future__ import annotations

from aqp_tpu_torch.experiments import sweep
from aqp_tpu_torch.harness import ExperimentConfig


def config(small: bool = False, device: str = "cuda") -> ExperimentConfig:
    if small:
        sizes = [(1 << k, 1 << 18) for k in (12, 14, 16)]
    else:
        sizes = [(1 << k, 52_428_800) for k in (17, 20, 23, 25, 27, 29)]
    return ExperimentConfig(algorithms=["RHO", "PHT"], sizes=sizes, reps=3,
                            alias_payloads=True, device=device)


def main(argv=None) -> list:
    args = sweep.parser(__doc__.splitlines()[0]).parse_args(argv)
    return sweep.run([config(args.small, args.device)], args)


if __name__ == "__main__":
    main()

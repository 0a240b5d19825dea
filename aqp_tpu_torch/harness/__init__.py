from aqp_tpu_torch.harness.runner import (
    ExperimentConfig,
    run_experiments,
    run_experiments_pipelined,
    rows_to_csv,
)

__all__ = ["ExperimentConfig", "run_experiments",
           "run_experiments_pipelined", "rows_to_csv"]

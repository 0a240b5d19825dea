from aqp_tpu_torch.utils.timing import PhaseTimer, Timings, hard_sync
from aqp_tpu_torch.utils.logging import get_logger

__all__ = [
    "PhaseTimer",
    "Timings",
    "get_logger",
    "hard_sync",
]

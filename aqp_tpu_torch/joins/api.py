"""Join dispatcher (counterpart of aqp_tpu/joins/api.py).

All 20 of the reference's names: the radix family RHO, RHO_seq, RHT and
RSM (joins/radix.py), the sort-merge engines PSM and MWAY
(joins/sortmerge.py), the no-partition family PHT, PHT_no, PHT_un, PHT_o,
NPO_st, NPO_no and NPBC_st (joins/nopart.py), CHT (joins/cht.py), NL and
INL (joins/nested.py), and the cracking joins CRKJ, CrkJoin, CRKJF and
CRKJS (joins/crk.py).  Any other name raises ValueError naming the
registered algorithms.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from aqp_tpu_torch import check_device
from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.joins import skewtier
from aqp_tpu_torch.relation import JoinResult, Relation
from aqp_tpu_torch.utils.timing import Timings

JoinEngine = Callable[[Relation, Relation, JoinConfig],
                      Tuple[JoinResult, Timings]]

JOIN_ALGORITHMS: Dict[str, JoinEngine] = {}


def register(name: str):
    def deco(fn):
        JOIN_ALGORITHMS[name] = fn
        return fn

    return deco


def run_join(relR: Relation, relS: Relation, algorithm: str = "RHO",
             config: Optional[JoinConfig] = None, device="cuda"
             ) -> Tuple[JoinResult, Timings]:
    """Dispatch a join by algorithm name, on `device` (where both
    relations must lie)."""
    if algorithm not in JOIN_ALGORITHMS:
        raise ValueError(f"Algorithm not found: {algorithm}. "
                         f"Known: {sorted(JOIN_ALGORITHMS)}")
    check_device(device, relR.key, relR.payload, relS.key, relS.payload)
    cfg = config or JoinConfig()
    result, timings = JOIN_ALGORITHMS[algorithm](relR, relS, cfg)
    timings.rows_in = relR.num_tuples + relS.num_tuples
    if cfg.defer:
        # no host synchronisation: matches stays on the device until
        # finalize_join
        timings.matches = -1
        return result, timings
    timings.matches = int(result.matches)
    return result, timings


def finalize_join(relR: Relation, relS: Relation, result: JoinResult,
                  timings: Timings, algorithm: str = "RHO",
                  config: Optional[JoinConfig] = None, device="cuda"
                  ) -> Tuple[JoinResult, Timings]:
    """Validate a deferred join result (waits for the device).  Returns the
    result itself, materialized columns and all, with `overflow` cleared.
    On an overflow, run the whole ladder again synchronously."""
    cfg = (config or JoinConfig()).replace(defer=False)
    check_device(device, relR.key, relS.key)
    if result.overflow is not None and int(result.overflow) != 0:
        # a sampled residual capacity that overflowed would overflow again
        # on every later deferred call for this relation: demote it first
        skewtier.demote_resid(relS.key)
        return run_join(relR, relS, algorithm, cfg, device=device)
    timings.matches = int(result.matches)
    return dataclasses.replace(result, overflow=None), timings


# Engine registration side effects:
from aqp_tpu_torch.joins import radix as _rx  # noqa: E402,F401
from aqp_tpu_torch.joins import nopart as _np  # noqa: E402,F401
from aqp_tpu_torch.joins import sortmerge as _sm  # noqa: E402,F401
from aqp_tpu_torch.joins import cht as _cht  # noqa: E402,F401
from aqp_tpu_torch.joins import nested as _nl  # noqa: E402,F401
from aqp_tpu_torch.joins import crk as _crk  # noqa: E402,F401

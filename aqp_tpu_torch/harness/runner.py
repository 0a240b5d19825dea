"""Experiment driver: config matrices -> long-format CSV rows (counterpart
of aqp_tpu/harness/runner.py).

The reference runs its binaries over a config matrix and appends
long-format CSV rows; here the joins run in-process and their Timings are
structured.  The CSV keeps the reference's long format:

    backend,alg,materialize,size_r,size_s,skew,selectivity,rep,measurement,value

`backend` names the device the matrix ran on (cuda or cpu).  Measurements
per run: every phase key (seconds), `matches`, `throughput_mrows`, and
with a profile directory `device_total_s` (utils/profiler.py).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Dict, Iterable, List, Optional, Sequence

import torch

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.config import JoinConfig
from aqp_tpu_torch.data import (
    create_relation_fk,
    create_relation_fk_sel,
    create_relation_pk,
    create_relation_zipf,
)
from aqp_tpu_torch.joins.api import finalize_join, run_join
from aqp_tpu_torch.relation import Relation
from aqp_tpu_torch.utils.logging import get_logger
from aqp_tpu_torch.utils.timing import hard_sync

log = get_logger("aqp_tpu_torch.harness")

CSV_HEADER = (
    "backend,alg,materialize,size_r,size_s,skew,selectivity,rep,measurement,value"
)


@dataclasses.dataclass
class ExperimentConfig:
    """Cartesian experiment matrix (the reference's ExperimentConfig)."""

    algorithms: Sequence[str] = ("RHO",)
    sizes: Sequence[tuple] = ((1 << 20, 1 << 22),)  # (|R|, |S|) pairs
    skews: Sequence[Optional[float]] = (None,)
    selectivities: Sequence[Optional[float]] = (None,)
    materialize: Sequence[bool] = (False,)
    reps: int = 3
    seed_r: int = 11111
    seed_s: int = 22222
    # run each (alg, workload, cfg) once unrecorded before rep 0, so that
    # the first call's set-up never lands in a measured row
    warmup: bool = True
    # trace each measured rep and emit a `device_total_s` row
    # (utils/profiler.py)
    profile_dir: Optional[str] = None
    # alias each relation's payload to its key (keys-only runs never read
    # payloads; halves the device memory of a large matrix)
    alias_payloads: bool = False
    # run the matrix with 8-byte keys (the reference's KEY_8B): int64
    # relations, which every engine serves without a kernel
    key64: bool = False
    # the reference-equivalent count configuration: no payload checksum
    checksum: bool = False
    # where the matrix runs; "cuda" needs a CUDA device
    device: str = "cuda"

    def enumerate(self):
        return itertools.product(
            self.algorithms, self.sizes, self.skews, self.selectivities,
            self.materialize, range(self.reps),
        )


def _gen_workload(size_r, size_s, skew, selectivity, seed_r, seed_s,
                  alias_payloads=False, device="cuda", key64=False):
    """The matrix's relations; with key64, pk and fk are drawn as int64 and
    zipf and fk_sel cast to it, as in the reference."""
    dtype = JoinConfig(key64=key64).key_dtype
    relR = create_relation_pk(size_r, seed=seed_r, dtype=dtype,
                              device=device)
    if skew is not None:
        relS = create_relation_zipf(size_s, size_r, skew, seed=seed_s,
                                    device=device)
    elif selectivity is not None:
        relS = create_relation_fk_sel(size_s, size_r, selectivity,
                                      seed=seed_s, device=device)
    else:
        relS = create_relation_fk(size_s, size_r, seed=seed_s, dtype=dtype,
                                  device=device)
    if key64 and relS.key.dtype != torch.int64:
        relS = Relation(relS.key.long(), relS.payload.long())
    if alias_payloads:
        relR = Relation(relR.key, relR.key)
        relS = Relation(relS.key, relS.key)
    hard_sync((relR.key, relS.key))
    return relR, relS


def run_experiments(cfg: ExperimentConfig,
                    backend: Optional[str] = None) -> List[Dict]:
    """Run the matrix on cfg.device; returns a list of long-format row
    dicts.  `backend` defaults to the device's type."""
    dev = resolve_device(cfg.device)
    backend = backend or dev.type
    rows: List[Dict] = []
    cache = {}
    warmed = set()
    for alg, (nr, ns), skew, sel, mat, rep in cfg.enumerate():
        wkey = (nr, ns, skew, sel)
        if wkey not in cache:
            cache.clear()  # keep at most one workload resident
            cache[wkey] = _gen_workload(nr, ns, skew, sel, cfg.seed_r,
                                        cfg.seed_s, cfg.alias_payloads, dev,
                                        cfg.key64)
        relR, relS = cache[wkey]
        jc = JoinConfig(materialize=mat, checksum=cfg.checksum,
                        key64=cfg.key64)
        try:
            if cfg.warmup and (alg, wkey, mat) not in warmed:
                run_join(relR, relS, alg, jc, device=dev)  # unrecorded
                warmed.add((alg, wkey, mat))
            if cfg.profile_dir:
                from aqp_tpu_torch.utils import profiler

                sub = os.path.join(cfg.profile_dir,
                                   f"{alg}_{nr}x{ns}_r{rep}")
                with profiler.trace(sub, device=dev):
                    result, t = run_join(relR, relS, alg, jc, device=dev)
                prep = profiler.parse_trace(sub)
            else:
                prep = None
                result, t = run_join(relR, relS, alg, jc, device=dev)
        except Exception as e:  # a failed run is a row, as the reference's
            log.error(f"{alg} {nr}x{ns} failed: {e}")
            rows.append(_row(backend, alg, mat, nr, ns, skew, sel, rep,
                             "error", 1.0))
            continue
        base = dict(
            backend=backend, alg=alg, materialize=int(mat), size_r=nr,
            size_s=ns, skew=skew if skew is not None else 0.0,
            selectivity=sel if sel is not None else 100.0, rep=rep,
        )
        for phase, secs in t.phases.items():
            rows.append({**base, "measurement": f"phase_{phase}_s",
                         "value": secs})
        rows.append({**base, "measurement": "matches",
                     "value": float(t.matches)})
        rows.append({**base, "measurement": "throughput_mrows",
                     "value": t.mrows_per_s})
        if prep is not None:
            rows.append({**base, "measurement": "device_total_s",
                         "value": prep.device_total_s})
        log.info(
            f"{alg} {nr}x{ns} skew={skew} sel={sel} mat={mat} rep={rep}: "
            f"{t.mrows_per_s:.1f} M rows/s, {t.matches} matches"
        )
    return rows


_PIPE_WARM = False


def run_experiments_pipelined(cfg: ExperimentConfig,
                              backend: Optional[str] = None) -> List[Dict]:
    """Pipelined variant of run_experiments (bench.py's method: calls
    back to back in one process, one wait at the end).

    Per configuration: one deferred call, validated through finalize_join
    (which walks the ladder on an overflow), then `reps` deferred calls
    issued back to back with a single wait at the end; the last result's
    overflow is read.  Emits the same long-format rows (phase_join_s =
    mean seconds a call)."""
    global _PIPE_WARM
    dev = resolve_device(cfg.device)
    backend = backend or dev.type
    rows: List[Dict] = []
    cache = {}
    for alg, (nr, ns), skew, sel, mat in itertools.product(
            cfg.algorithms, cfg.sizes, cfg.skews, cfg.selectivities,
            cfg.materialize):
        wkey = (nr, ns, skew, sel)
        if wkey not in cache:
            cache.clear()
            cache[wkey] = _gen_workload(nr, ns, skew, sel, cfg.seed_r,
                                        cfg.seed_s, cfg.alias_payloads, dev,
                                        cfg.key64)
        relR, relS = cache[wkey]
        jc = JoinConfig(materialize=mat, checksum=cfg.checksum,
                        key64=cfg.key64, defer=True)
        try:
            res, t = run_join(relR, relS, alg, jc, device=dev)  # unrecorded
            res, t = finalize_join(relR, relS, res, t, alg, jc, device=dev)
            matches = t.matches
            if not _PIPE_WARM:
                # the process's first timed loop, once: its allocations
                # and first launches land outside every measured row
                for _ in range(2):
                    res, _t2 = run_join(relR, relS, alg, jc, device=dev)
                hard_sync(res.matches)
                _PIPE_WARM = True
            t0 = time.perf_counter()
            for _ in range(cfg.reps):
                res, _ = run_join(relR, relS, alg, jc, device=dev)
            hard_sync(res.matches)
            dt = (time.perf_counter() - t0) / cfg.reps
            if res.overflow is not None and int(res.overflow) != 0:
                # the deferred tier overflowed mid-loop: the timing is not
                # a valid serving number; record the synchronous ladder's
                # instead (never a silently wrong row)
                log.error(f"{alg} {nr}x{ns}: deferred tier overflowed; "
                          "recording synchronous escalation timing")
                sync_cfg = jc.replace(defer=False)
                t1 = time.perf_counter()
                res2, t2 = run_join(relR, relS, alg, sync_cfg, device=dev)
                dt = time.perf_counter() - t1
                matches = t2.matches
        except Exception as e:  # a failed run is a row, as the reference's
            log.error(f"{alg} {nr}x{ns} failed: {e}")
            rows.append(_row(backend, alg, mat, nr, ns, skew, sel, 0,
                             "error", 1.0))
            continue
        for rep in range(cfg.reps):
            base = dict(
                backend=backend, alg=alg, materialize=int(mat), size_r=nr,
                size_s=ns, skew=skew if skew is not None else 0.0,
                selectivity=sel if sel is not None else 100.0, rep=rep,
            )
            rows.append({**base, "measurement": "phase_join_s", "value": dt})
            rows.append({**base, "measurement": "phase_total_s", "value": dt})
            rows.append({**base, "measurement": "matches",
                         "value": float(matches)})
            rows.append({**base, "measurement": "throughput_mrows",
                         "value": (nr + ns) / dt / 1e6})
        log.info(f"{alg} {nr}x{ns} skew={skew} sel={sel} mat={mat} "
                 f"pipelined: {(nr + ns) / dt / 1e6:.1f} M rows/s, "
                 f"{matches} matches")
    return rows


def _row(backend, alg, mat, nr, ns, skew, sel, rep, measurement, value):
    return dict(
        backend=backend, alg=alg, materialize=int(mat), size_r=nr, size_s=ns,
        skew=skew if skew is not None else 0.0,
        selectivity=sel if sel is not None else 100.0, rep=rep,
        measurement=measurement, value=value,
    )


def rows_to_csv(rows: Iterable[Dict], path: str, append: bool = False) -> None:
    mode = "a" if append else "w"
    with open(path, mode) as f:
        if not append:
            f.write(CSV_HEADER + "\n")
        for r in rows:
            f.write(
                f"{r['backend']},{r['alg']},{r['materialize']},{r['size_r']},"
                f"{r['size_s']},{r['skew']},{r['selectivity']},{r['rep']},"
                f"{r['measurement']},{r['value']}\n"
            )

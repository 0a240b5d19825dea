"""Phase timing and the metric contract (counterpart of aqp_tpu/utils/timing.py).

Phases are timed with CUDA events on a CUDA device and with perf_counter on
the CPU.  Throughput follows the reference: M input rows/s =
(|R| + |S|) / total seconds / 1e6.
"""

from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Dict

import torch

def _tensors(x):
    """The tensors in x (a tensor, or a list, tuple, dict or dataclass of
    them, nested), in order."""
    if isinstance(x, torch.Tensor):
        yield x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))
    elif isinstance(x, (list, tuple)):
        for item in x:
            yield from _tensors(item)
    elif isinstance(x, dict):
        for item in x.values():
            yield from _tensors(item)


def hard_sync(x):
    """Wait until the device of the first tensor in x has finished its work;
    on the CPU (or with no tensor in x) nothing to wait for.  Returns x
    unchanged."""
    t = next(_tensors(x), None)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return x


PHASE_KEYS = (
    "total",
    "partition",
    "partition_pass1",
    "partition_pass2",
    "build",
    "probe",
    "join",
    "sort",
    "merge",
    "filter",
    "materialize",
    "shuffle",
)


@dataclass
class Timings:
    """Seconds per phase + derived throughput."""

    phases: Dict[str, float] = field(default_factory=dict)
    rows_in: int = 0
    matches: int = 0

    @property
    def total(self) -> float:
        return self.phases.get("total", sum(self.phases.values()))

    @property
    def mrows_per_s(self) -> float:
        t = self.total
        return (self.rows_in / t / 1e6) if t > 0 else float("inf")

    def print_contract(self) -> None:
        """Grep-able fixed-format lines (the reference's print_timing)."""
        for k in PHASE_KEYS:
            if k in self.phases:
                print(f"{k.replace('_', ' ').title()} Time (s): "
                      f"{self.phases[k]:.6f}")
        print(f"Result tuples: {self.matches}")
        print(f"Throughput (M rec/sec): {self.mrows_per_s:.4f}")

    def json_line(self, **extra) -> str:
        d = dict(phases=self.phases, rows_in=self.rows_in,
                 matches=self.matches, mrows_per_s=self.mrows_per_s)
        d.update(extra)
        return json.dumps(d)


class PhaseTimer:
    """Phase timer around device work on one device."""

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self.t = Timings()

    def _add(self, name: str, secs: float) -> None:
        self.t.phases[name] = self.t.phases.get(name, 0.0) + secs

    def time_fn(self, name: str, fn, *args, **kw):
        """Run fn and add the time until the device has finished it: CUDA
        events on a CUDA device, perf_counter on the CPU."""
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self._add(name, time.perf_counter() - t0)
            return out
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn(*args, **kw)
        b.record()
        b.synchronize()
        self._add(name, a.elapsed_time(b) / 1e3)
        return out

    def submit_fn(self, name: str, fn, *args, **kw):
        """Deferred serving mode (JoinConfig.defer): records the host's
        submission time only and never waits for the device."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self._add(name, time.perf_counter() - t0)
        return out


def mean_ms(fn, device, reps: int = 5):
    """Mean milliseconds per call over `reps` calls issued back to back
    after one warm-up call, and the last call's output: CUDA events around
    the loop on a CUDA device (the device's time to finish the calls, one
    wait at the end, as the JAX drivers' pipelined timing), perf_counter
    on the CPU."""
    device = torch.device(device)
    out = fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return (time.perf_counter() - t0) * 1e3 / reps, out
    torch.cuda.synchronize(device)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps, out


def best_ms(fn, device, iters: int = 3) -> float:
    """Least milliseconds of one call of fn over `iters` calls after one
    warm-up call: CUDA events around each call on a CUDA device (the
    device's time to finish it), perf_counter on the CPU."""
    device = torch.device(device)
    fn()
    best = float("inf")
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms)
    return best

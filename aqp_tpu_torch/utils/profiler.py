"""Device profiler layer on torch.profiler (counterpart of
aqp_tpu/utils/profiler.py, the PerfEvent analog).

  * `trace(logdir)`: a `torch.profiler` trace (CPU, and CUDA on a CUDA
    device) around a section, written under `logdir` as a Chrome trace
    (`<time>.trace.json`, opens in Perfetto or chrome://tracing).
  * `parse_trace(logdir)`: the device's time from the newest such trace:
    the union of its kernel, memcpy and memset intervals (the time the
    device was busy, free of host dispatch), the union of the host's
    events, and each kernel's time and calls by name.
  * `counters(fn, *args)`: the bytes a call must move (each tensor input
    read once, each tensor output written once) and its FLOPs
    (`torch.utils.flop_counter`), with rates and the memory roofline share
    for a measured `seconds`.

CLI: every `python -m aqp_tpu_torch` subcommand takes `--profile DIR`,
which wraps the measured section in `trace()` and adds `parse_trace()`'s
device seconds to the printed JSON (and `matrix` a `device_total_s` row).

A trace taken on a CUDA device that holds host events but no device event
makes `parse_trace` raise: the device was not recorded, and a 0 would be
a host number reported as a device one.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.flop_counter import FlopCounterMode

from aqp_tpu_torch.utils.timing import _tensors, hard_sync

# H100 SXM data sheet: 3.35 TB/s of HBM3 at the full 700 W power limit
# (the H100 80GB HBM3 card, 700.00 W limit).  Used only for the
# utilization ratio in counter reports.
PEAK_HBM_GBS = 3350.0

# Chrome-trace categories of the device's own work (kineto's names).
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The profiler's whole-window span and the device-side copies of host
# annotations: neither is work of the host.
_NOT_HOST_CATS = ("trace", "gpu_user_annotation")
# Key under which `trace` notes in the written trace whether CUDA was traced.
META_KEY = "aqp_tpu_torch"


@dataclass
class TraceReport:
    """Device-side timing extracted from a torch.profiler trace."""

    device_total_s: float = 0.0          # union of kernel/memcpy/memset
    host_total_s: float = 0.0            # union of the host's events
    per_program_s: Dict[str, float] = field(default_factory=dict)
    per_program_calls: Dict[str, int] = field(default_factory=dict)
    trace_path: Optional[str] = None

    def to_dict(self) -> dict:
        return {
            "device_total_s": round(self.device_total_s, 6),
            "host_total_s": round(self.host_total_s, 6),
            "per_program_s": {k: round(v, 6)
                              for k, v in sorted(self.per_program_s.items())},
            "per_program_calls": dict(sorted(self.per_program_calls.items())),
            "trace_path": self.trace_path,
        }


def _activities(cuda: bool) -> list:
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


@contextmanager
def trace(logdir: str, device=None):
    """Trace the section into `logdir`: the host always, the CUDA device
    too when `device` is a CUDA device (default: whenever one exists).
    The device's pending work is waited for at both ends, so the trace
    holds the section's work and nothing before it."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    cuda = dev.type == "cuda"
    os.makedirs(logdir, exist_ok=True)
    if cuda:
        torch.cuda.synchronize(dev)
    with profile(activities=_activities(cuda)) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(dev)
    path = os.path.join(logdir, f"{time.time_ns():020d}.trace.json")
    tmp = f"{path}.{os.getpid()}.tmp"
    prof.export_chrome_trace(tmp)
    with open(tmp) as fh:
        data = json.load(fh)
    data[META_KEY] = {"cuda": cuda}
    with open(tmp, "w") as fh:
        json.dump(data, fh)
    os.replace(tmp, path)


def _interval_union(iv: List[tuple]) -> float:
    if not iv:
        return 0.0
    iv.sort()
    total = 0.0
    cur_s, cur_e = iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def parse_trace(logdir: str) -> TraceReport:
    """Device and host busy time from the newest trace under `logdir`.

    Device events are the trace's kernel, memcpy and memset events; their
    union is the device's busy time (copies can overlap kernels, so a sum
    would count twice).  Host events are the others but the profiler's
    whole-window span.  per_program_s / per_program_calls sum the kernels
    by name.  Raises when a CUDA trace holds host events but no device
    event."""
    paths = sorted(glob.glob(os.path.join(logdir, "*.trace.json")))
    rep = TraceReport()
    if not paths:
        return rep
    path = paths[-1]
    rep.trace_path = path
    with open(path) as fh:
        data = json.load(fh)
    dev_iv: List[tuple] = []
    host_iv: List[tuple] = []
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts = float(e.get("ts", 0.0)) * 1e-6
        dur = float(e.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            dev_iv.append((ts, ts + dur))
            if cat == "kernel":
                name = e.get("name", "")
                rep.per_program_s[name] = rep.per_program_s.get(name,
                                                                0.0) + dur
                rep.per_program_calls[name] = (
                    rep.per_program_calls.get(name, 0) + 1)
        elif cat not in _NOT_HOST_CATS:
            host_iv.append((ts, ts + dur))
    if data.get(META_KEY, {}).get("cuda") and host_iv and not dev_iv:
        raise RuntimeError(
            f"{path}: the CUDA device was traced, but the trace holds no "
            "kernel, memcpy or memset event (the profiler recorded no device "
            "activity); its device time is unknown, not 0")
    rep.device_total_s = _interval_union(dev_iv)
    rep.host_total_s = _interval_union(host_iv)
    return rep


def profile_fn(fn: Callable, *args, logdir: Optional[str] = None,
               reps: int = 1, device=None):
    """Run `fn(*args)` `reps` times under a trace (after one call outside
    it); return (last result, TraceReport).  `logdir` defaults to a new
    temporary directory."""
    out = hard_sync(fn(*args))
    logdir = logdir or tempfile.mkdtemp(prefix="aqp_profile_")
    with trace(logdir, device=device):
        for _ in range(reps):
            out = fn(*args)
        hard_sync(out)
    return out, parse_trace(logdir)


def counters(fn: Callable, *args, seconds: Optional[float] = None) -> dict:
    """PerfEvent-style counter block for one call of `fn(*args)`.

    bytes_accessed counts each tensor argument read once and each tensor
    of the result written once; flops are what
    torch.utils.flop_counter.FlopCounterMode counts (matrix products,
    convolutions; 0 for a join or a scan).  With a measured `seconds`,
    GFLOP/s, GB/s and the share of the HBM rate are added."""
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    hard_sync(out)
    byt = float(sum(t.numel() * t.element_size()
                    for t in (*_tensors(args), *_tensors(out))))
    flops = float(fc.get_total_flops())
    res = {"flops": flops, "bytes_accessed": byt}
    if seconds and seconds > 0:
        res["gflops_per_s"] = round(flops / seconds / 1e9, 2)
        res["gb_per_s"] = round(byt / seconds / 1e9, 2)
        res["hbm_utilization"] = round(byt / seconds / 1e9 / PEAK_HBM_GBS, 4)
        res["seconds"] = seconds
    return res

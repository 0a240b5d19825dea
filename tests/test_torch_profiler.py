"""The port's profiler layer (utils/profiler.py, on torch.profiler) on the
CPU: the interval union against the reference's, parse_trace on a
hand-written Chrome trace, a real trace read back, the report's keys,
the counters' byte count, and the raise on a CUDA trace without device
events."""

import json

import numpy as np
import pytest
import torch

from aqp_tpu.utils import profiler as jprofiler
from aqp_tpu_torch.utils import profiler


def _random_intervals(rng, n):
    starts = rng.uniform(0, 100, n)
    return [(float(s), float(s + d))
            for s, d in zip(starts, rng.exponential(5, n))]


@pytest.mark.parametrize("seed", range(6))
def test_interval_union_equals_the_references(seed):
    rng = np.random.default_rng(seed)
    cases = [[], [(1.0, 1.0)], [(0.0, 10.0), (2.0, 3.0), (4.0, 12.0)],
             [(5.0, 6.0), (0.0, 1.0), (1.0, 2.0)],
             _random_intervals(rng, 1 + seed * 20)]
    for iv in cases:
        got = profiler._interval_union(list(iv))
        assert got == jprofiler._interval_union(list(iv))
        # a point set on a fine grid gives the same measure
        if iv:
            grid = np.linspace(0, 200, 200_001)
            cover = np.zeros(grid.shape, bool)
            for s, e in iv:
                cover |= (grid >= s) & (grid < e)
            assert abs(cover.sum() * 0.001 - got) < 0.001 * (len(iv) + 1)


def _event(cat, name, ts, dur, pid=1, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur}


def _write(logdir, events, cuda, name="00000000000000000001"):
    logdir.mkdir(parents=True, exist_ok=True)
    data = {"traceEvents": events, profiler.META_KEY: {"cuda": cuda}}
    (logdir / f"{name}.trace.json").write_text(json.dumps(data))


def test_parse_trace_on_a_handwritten_trace(tmp_path):
    events = [
        _event("Trace", "PyTorch Profiler (0)", 0, 10_000),
        _event("cpu_op", "aten::sort", 100, 400),
        _event("cuda_runtime", "cudaLaunchKernel", 150, 20),
        _event("cpu_op", "aten::sum", 1_000, 100),
        _event("kernel", "k1_kernel", 200, 300, pid=0, tid=7),
        _event("kernel", "k1_kernel", 1_100, 100, pid=0, tid=7),
        _event("kernel", "k3_kernel", 450, 100, pid=0, tid=8),
        _event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 2_000, 50,
               pid=0, tid=9),
        _event("gpu_memset", "Memset (Device)", 2_040, 20, pid=0, tid=7),
        _event("gpu_user_annotation", "join", 0, 9_000, pid=0, tid=7),
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
    ]
    _write(tmp_path / "a", events, cuda=True)
    # an older trace beside it is not read
    _write(tmp_path / "a", [_event("kernel", "old", 0, 5)], cuda=True,
           name="00000000000000000000")
    rep = profiler.parse_trace(str(tmp_path / "a"))
    # device: [200, 550) + [1100, 1200) + [2000, 2060) microseconds
    assert rep.device_total_s == pytest.approx((350 + 100 + 60) * 1e-6)
    # host: [100, 500) + [1000, 1100)
    assert rep.host_total_s == pytest.approx(500 * 1e-6)
    assert rep.per_program_calls == {"k1_kernel": 2, "k3_kernel": 1}
    assert rep.per_program_s == pytest.approx({"k1_kernel": 400e-6,
                                               "k3_kernel": 100e-6})
    assert rep.trace_path.endswith("00000000000000000001.trace.json")
    assert profiler.parse_trace(str(tmp_path / "none")).trace_path is None


def test_a_real_cpu_trace_reads_back(tmp_path):
    with profiler.trace(str(tmp_path), device="cpu"):
        torch.sort(torch.randn(50_000))
    rep = profiler.parse_trace(str(tmp_path))
    assert rep.host_total_s > 0
    assert rep.device_total_s == 0.0
    assert rep.per_program_calls == {}
    out, rep2 = profiler.profile_fn(lambda x: x.sum(), torch.ones(8),
                                    logdir=str(tmp_path / "f"), reps=2,
                                    device="cpu")
    assert int(out) == 8 and rep2.host_total_s > 0


def test_trace_report_keys_equal_the_references():
    got = profiler.TraceReport(1.0, 2.0, {"b": 0.5, "a": 0.25},
                               {"b": 2, "a": 1}, "p").to_dict()
    want = jprofiler.TraceReport(1.0, 2.0, {"b": 0.5, "a": 0.25},
                                 {"b": 2, "a": 1}, "p").to_dict()
    assert got == want
    assert list(got) == list(want)


def test_counters_count_each_input_and_output_once():
    a = torch.ones((64, 32), dtype=torch.float32)
    b = torch.ones((32, 16), dtype=torch.float32)
    c = profiler.counters(torch.mm, a, b, seconds=1e-3)
    assert c["bytes_accessed"] == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert c["flops"] == 2 * 64 * 32 * 16
    assert c["gb_per_s"] == round(c["bytes_accessed"] / 1e-3 / 1e9, 2)
    assert c["hbm_utilization"] == round(
        c["bytes_accessed"] / 1e-3 / 1e9 / profiler.PEAK_HBM_GBS, 4)
    k = torch.arange(100, dtype=torch.int32)
    c = profiler.counters(lambda x: (x + 1, x > 5), k)
    assert c == {"flops": 0.0, "bytes_accessed": 400.0 + 400 + 100}


def test_cuda_trace_without_device_events_raises(tmp_path, monkeypatch):
    host = [_event("cpu_op", "aten::sort", 0, 10),
            _event("cuda_runtime", "cudaLaunchKernel", 2, 1)]
    _write(tmp_path / "cuda", host, cuda=True)
    with pytest.raises(RuntimeError, match="no kernel, memcpy or memset"):
        profiler.parse_trace(str(tmp_path / "cuda"))
    # the same events from a CPU section are a host-only trace
    _write(tmp_path / "cpu", host, cuda=False)
    assert profiler.parse_trace(str(tmp_path / "cpu")).device_total_s == 0
    # trace() notes the CUDA check's answer in the trace it writes
    monkeypatch.setattr(profiler, "_activities",
                        lambda cuda: [profiler.ProfilerActivity.CPU])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with profiler.trace(str(tmp_path / "real"), device="cuda"):
        torch.sort(torch.randn(1000))
    with pytest.raises(RuntimeError, match="no kernel, memcpy or memset"):
        profiler.parse_trace(str(tmp_path / "real"))

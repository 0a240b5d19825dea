"""Every kernel wrapper's launch branch, run on the CPU against a stand-in
library: the arguments each wrapper passes must fit the C signature it
calls (count and kind), outputs come back in the documented shapes, and
each launch is counted once.  (The kernels themselves run where a card is,
in chip_smoke.py.)"""

import ctypes

import pytest
import torch

from aqp_tpu_torch.ops.kernels import (aggpipe, blocksort, build, compact,
                                       lanecompact, nphj, rho3, rstats, scan)

KINDS = {ctypes.c_void_p: (int, type(None)), ctypes.c_int: (int,),
         ctypes.c_longlong: (int,), ctypes.c_float: (float,)}


class FakeLib:
    """Checks each call against build.SIGNATURES and returns success."""

    def __init__(self):
        self.calls = []
        self.args = []

    def __getattr__(self, name):
        argtypes, _ = build.SIGNATURES[name]

        def fn(*args):
            assert len(args) == len(argtypes), (name, len(args))
            for i, (a, t) in enumerate(zip(args, argtypes)):
                assert isinstance(a, KINDS[t]), (name, i, type(a))
            self.calls.append(name)
            self.args.append(args)
            if name == "rho3_k3_max_cap":
                return 32768
            if name == "rho3_max_slot":
                return 8192 if args[0] == 1 else 16384
            if name == "rho3_max_group":
                return 1024
            if name == "rstats_max_h":
                return 1024
            return 0

        return fn


@pytest.fixture
def lib(monkeypatch):
    fake = FakeLib()
    monkeypatch.setattr(build, "load", lambda: fake)
    for mod in (rho3, compact, lanecompact, scan, aggpipe, nphj, rstats,
                blocksort):
        monkeypatch.setattr(mod, "on_cuda", lambda x: True)
        monkeypatch.setattr(mod, "stream", lambda device: 0)
    return fake


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def _counters():
    out = {}
    for c in (rho3.LAUNCHES, lanecompact.LAUNCHES, compact.LAUNCHES,
              scan.LAUNCHES, aggpipe.LAUNCHES, nphj.LAUNCHES,
              rstats.LAUNCHES, blocksort.LAUNCHES):
        out.update(c)
    return out


NO_LAUNCH = {"K1": 0, "K2": 0, "K3": 0, "K3M": 0, "compact_windows": 0,
             "compact_windows_index": 0, "compact_windows_values": 0,
             "compact_windows_dict": 0, "scatter_segments": 0,
             "scatter_segments_one": 0, "scan_count": 0, "scan_sum": 0,
             "scan_bitvector": 0, "K3AGG": 0, "K3TWO": 0, "K3TWO_MAT": 0,
             "RSTATS": 0, "sort_hist": 0, "sort_blocks": 0, "tile_plan": 0}


def test_each_wrapper_calls_its_launcher_once(lib):
    prm = rho3.Rho3Params(block_rows=128, slot_rows=8, f1=20, f2=4,
                          kd_slot_rows=16)
    nb, nbg = 32, 2
    before = _counters()
    for pay in (None, _i32(1000)):
        k, p, cnt, _ = rho3.k1(_i32(1000), pay, nb, prm, 1.0)
        assert k.shape == (nb, prm.f1, prm.cap1) and cnt.shape == (nb, 20)
        assert (p is None) == (pay is None)
        k2, p2, cnt2, _ = rho3.k2(k, p, cnt, prm, 1.0)
        assert k2.shape == (prm.f1, nbg, prm.f2, prm.cap2)
        m, c = rho3.k3(k2, p2, cnt2)
        assert m.shape == c.shape == ()
    m, c, ok, orp, osp = rho3.k3m(k2, p2, cnt2, 7)
    assert ok.shape == orp.shape == osp.shape == (k2.numel(),)
    # K3M: K3's geometry and sub-ranges, inv, and the halving counter
    k3m_args = lib.args[lib.calls.index("rho3_k3m")]
    assert k3m_args[3:9] == (prm.f1, nbg, prm.f2, prm.cap2,
                             rho3.subranges(nbg, prm.cap2), 7)
    assert k3m_args[9:12] == tuple(t.data_ptr() for t in (ok, orp, osp))
    assert k3m_args[14] == rho3.halving_counter("cpu").data_ptr()
    col = _i32(10_000)
    for payloads, fills in (([col, _i32(10_000)], (5, 0)), ([col], (5,))):
        blocks, counts = lanecompact._compact_windows(col, payloads, 0, 9, 8,
                                                      fills, 4)
        assert counts.shape == (10,)
        assert [b.shape for b in blocks] == [(10, 4, 128)] * len(payloads)
    rows = _i32(40, 128)
    d = _i32(10)
    ok, op = compact.scatter_segments(rows, rows, d, d, d, 10, 21, 5)
    assert ok.shape == op.shape == (21, 128)
    one = compact.scatter_segments_one(rows, d, d, d, 10, 21, 5)
    assert one.shape == (21, 128)
    # the kernel fills the rows no segment covers: the wrapper passes the
    # fill key, and the outputs, each written by the kernel alone
    scatter_args = [a for n, a in zip(lib.calls, lib.args)
                    if n == "scatter_segments"]
    assert [a[8] for a in scatter_args] == [5, 5]
    assert scatter_args[0][9:11] == (ok.data_ptr(), op.data_ptr())
    assert scatter_args[1][9:11] == (one.data_ptr(), None)
    assert [n for n in lib.calls if n.startswith(("rho3_k", "compact",
                                                  "scatter"))
            and n not in ("rho3_k3_max_cap", "rho3_max_slot",
                          "rho3_max_group")] == [
        "rho3_k1", "rho3_k2", "rho3_k3", "rho3_k1", "rho3_k2", "rho3_k3",
        "rho3_k3m", "compact_windows", "compact_windows",
        "scatter_segments", "scatter_segments"]
    after = _counters()
    assert {k: after[k] - before[k] for k in after} == dict(
        NO_LAUNCH, K1=2, K2=2, K3=2, K3M=1, compact_windows=2,
        scatter_segments=1, scatter_segments_one=1)


def test_k1_and_k2_pass_their_geometry_to_the_launchers(lib):
    """K1 gets the block, fanouts, scale and slot capacity; K2 the window
    (group K1 slots), the fine fanout and capacity; both at the skew
    residual's cap2 of 16,384."""
    prm = rho3.Rho3Params(kd_slot_rows=128)
    nb = prm.group
    k, p, cnt, _ = rho3.k1(_i32(5000), _i32(5000), nb, prm, 0.5)
    rho3.k2(k, p, cnt, prm, 0.5)
    (k1_args,), (k2_args,) = ([a for n, a in zip(lib.calls, lib.args)
                               if n == f"rho3_k{i}"] for i in (1, 2))
    assert k1_args[2:9] == (5000, nb, prm.block, prm.f1, prm.f2, 0.5,
                            prm.cap1)
    assert k2_args[3:10] == (prm.f1, prm.group, prm.cap1, prm.f2, 1, 0.5,
                             prm.cap2)
    assert prm.cap2 == 16384


def test_k1_and_k2_reject_slots_and_windows_past_the_kernels(lib):
    """Slots above rho3_max_slot(k) values (K1 8,192, K2 16,384), and
    windows of more K1 slots than rho3_max_group(), raise before any
    launch."""
    big = rho3.Rho3Params(slot_rows=128, f1=2, kd_slot_rows=256)
    with pytest.raises(ValueError, match="slots of 16384 exceed K1's 8192"):
        rho3.k1(_i32(100), None, big.group, big, 1.0)
    k = _i32(big.group, big.f1, big.cap1)
    cnt = _i32(big.group, big.f1)
    with pytest.raises(ValueError, match="slots of 32768 exceed K2's 16384"):
        rho3.k2(k, None, cnt, big, 1.0)
    wide = rho3.Rho3Params(block_rows=16384, slot_rows=8, f1=2)
    assert wide.group == 2048
    with pytest.raises(ValueError, match="2048 K1 slots exceed K2"):
        rho3.k2(_i32(wide.group, wide.f1, wide.cap1), None,
                _i32(wide.group, wide.f1), wide, 1.0)
    assert not [n for n in lib.calls if n in ("rho3_k1", "rho3_k2")]


def test_k3_and_k3two_pass_sub_ranges_and_the_halving_counter(lib):
    """K3 gets its geometry and P = subranges(nbg, cap2) sub-ranges a
    region, K3TWO P = subranges(nbg_r + nbg_s, cap2); both add to the
    device's halving counter (one tensor, kept across calls), and zeroed
    matches and checksum."""
    f1, nbg, f2, cap2 = 3, 16, 4, 8192
    k2, cnt2 = _i32(f1, nbg, f2, cap2), _i32(f1, nbg, f2)
    counter = rho3.halving_counter("cpu")
    assert counter.shape == () and counter.dtype == torch.int64
    for p2 in (None, k2):
        rho3.k3(k2, p2, cnt2)
    tk, tc = _i32(f1, 4, f2, cap2), _i32(f1, 4, f2)
    for tp, sp in ((None, None), (tk, k2)):
        nphj.k3two(tk, tp, tc, k2, sp, cnt2)
    k3_calls = [a for n, a in zip(lib.calls, lib.args) if n == "rho3_k3"]
    two_calls = [a for n, a in zip(lib.calls, lib.args) if n == "nphj_k3two"]
    assert [a[1] is None for a in k3_calls] == [True, False]
    assert [a[1] is None for a in two_calls] == [True, False]
    for a in k3_calls:
        assert a[3:8] == (f1, nbg, f2, cap2, 8)
        assert a[10] == counter.data_ptr()
    for a in two_calls:
        assert (a[3], a[7]) == (4, nbg)
        assert a[8:12] == (f1, f2, cap2, 10)
        assert a[14] == counter.data_ptr()
    assert rho3.halving_counter("cpu") is counter
    assert rho3.subranges(nbg, cap2) == 8
    assert rho3.subranges(4 + nbg, cap2) == 10


def test_region_joins_report_fine_slots_past_their_capacity(lib):
    """cap2 up to rho3_k3_max_cap() (32,768) launches K3 and K3TWO, with or
    without payloads, and K3M and K3TWO_MAT (their shared memory does not
    grow with cap2); past it they raise before a launch."""
    f1, f2 = 1, 1
    for cap2, ok in ((32768, True), (65536, False)):
        k, cnt = _i32(f1, 1, f2, cap2), _i32(f1, 1, f2)
        for pay in (None, k):
            if ok:
                rho3.k3(k, pay, cnt)
                nphj.k3two(k, pay, cnt, k, pay, cnt)
            else:
                with pytest.raises(ValueError, match="exceed K3's 32768"):
                    rho3.k3(k, pay, cnt)
                with pytest.raises(ValueError, match="exceed K3TWO's"):
                    nphj.k3two(k, pay, cnt, k, pay, cnt)
        if ok:
            rho3.k3m(k, k, cnt, 1)
            nphj.k3two_mat(k, k, cnt, k, k, cnt, 1)
        else:
            with pytest.raises(ValueError, match="exceed K3M's 32768"):
                rho3.k3m(k, k, cnt, 1)
            with pytest.raises(ValueError, match="exceed K3TWO_MAT's 32768"):
                nphj.k3two_mat(k, k, cnt, k, k, cnt, 1)
    assert [n for n in lib.calls if n in ("rho3_k3", "nphj_k3two",
                                          "rho3_k3m", "nphj_k3two_mat")] == [
        "rho3_k3", "nphj_k3two", "rho3_k3", "nphj_k3two", "rho3_k3m",
        "nphj_k3two_mat"]
    # the capacity is the only limit the wrappers ask the library for
    assert set(lib.calls) == {"rho3_k3", "nphj_k3two", "rho3_k3m",
                              "nphj_k3two_mat", "rho3_k3_max_cap"}


def test_scan_and_aggregate_wrappers_call_their_launchers_once(lib):
    col = torch.zeros(10_001, dtype=torch.uint8)
    before = _counters()
    for fn in (scan.count, scan.sum_):
        out = fn(col, 3, 300)
        assert out.shape == () and out.dtype == torch.int64
    bv = scan.bitvector(col, -1, 9)
    assert bv.shape == (1251,) and bv.dtype == torch.uint8
    table = _i32(256)
    for kw, nout in (({}, 1), ({"with_values": True}, 2),
                     ({"dict_tables": (table, table)}, 3)):
        fills = (0,) if kw.get("with_values") else ()
        blocks, counts = lanecompact._compact_windows(
            col, [], 0, 9, 8, fills, 4, with_ids=True, **kw)
        assert counts.shape == (10,)
        assert [b.shape for b in blocks] == [(10, 4, 128)] * nout
    k2 = _i32(6, 2, 4, 256)
    outs = aggpipe.k3agg(k2, k2, _i32(6, 2, 4))
    assert [o.shape for o in outs] == [(24, 512)] * 5 + [(24,)]
    # K3AGG: its geometry, P sub-ranges a region, the five scratch blocks
    # and the sub-ranges' two ints, the outputs, the halving counter
    agg_args = lib.args[lib.calls.index("aggpipe_k3agg")]
    assert agg_args[3:8] == (6, 2, 4, 256, rho3.subranges(2, 256))
    assert agg_args[15:21] == tuple(o.data_ptr() for o in outs)
    assert agg_args[21] == rho3.halving_counter("cpu").data_ptr()
    assert [n for n in lib.calls if n != "rho3_error_string"] == [
        "scan_reduce", "scan_reduce", "scan_bitvector", "compact_windows",
        "compact_windows", "compact_windows", "aggpipe_k3agg"]
    after = _counters()
    assert {k: after[k] - before[k] for k in after} == dict(
        NO_LAUNCH, scan_count=1, scan_sum=1, scan_bitvector=1,
        compact_windows_index=1, compact_windows_values=1,
        compact_windows_dict=1, K3AGG=1)


def test_wrappers_reject_what_the_kernels_do_not_take(lib):
    slots = _i32(2, 1, 4, 128)
    cnt = _i32(2, 1, 4)
    with pytest.raises(ValueError, match="needs the payloads"):
        rho3.k3m(slots, None, cnt, 1)
    with pytest.raises(TypeError, match="int32"):
        rho3.k3(slots.long(), None, cnt)
    with pytest.raises(ValueError, match="one or two payload arrays"):
        lanecompact._compact_windows(_i32(8), [], 0, 1, 8, ())
    rows = _i32(4, 128)
    d = _i32(2)
    with pytest.raises(ValueError, match="shape"):
        compact.scatter_segments(rows, _i32(3, 128), d, d, d, 2, 5)
    with pytest.raises(ValueError, match="aligned"):
        compact.scatter_segments_one(_i32(4 * 128 + 1)[1:].view(4, 128),
                                     d, d, d, 2, 5)
    with pytest.raises(TypeError, match="uint8"):
        scan.count(_i32(64), 0, 9)
    with pytest.raises(TypeError, match="int32 or uint8"):
        lanecompact._compact_windows(_i32(64).long(), [], 0, 9, 8, (),
                                     with_ids=True)
    with pytest.raises(ValueError, match="shape"):
        lanecompact._compact_windows(_i32(64), [], 0, 9, 8, (), with_ids=True,
                                     dict_tables=(_i32(128), _i32(128)))
    with pytest.raises(TypeError, match="int32"):
        aggpipe.k3agg(slots.long(), slots, cnt)


def test_nphj_and_rstats_wrappers_call_their_launchers_once(lib):
    f1, nbg_r, nbg_s, f2, cap2 = 3, 2, 5, 4, 256
    tk, sk = _i32(f1, nbg_r, f2, cap2), _i32(f1, nbg_s, f2, cap2)
    tc, sc = _i32(f1, nbg_r, f2), _i32(f1, nbg_s, f2)
    before = _counters()
    for tp, sp in ((None, None), (tk, sk)):
        m, c = nphj.k3two(tk, tp, tc, sk, sp, sc)
        assert m.shape == c.shape == () and m.dtype == c.dtype == torch.int64
    m, c, ok, orp, osp = nphj.k3two_mat(tk, tk, tc, sk, sk, sc, 7)
    n = f1 * f2 * 2 * max(nbg_r, nbg_s) * cap2
    assert ok.shape == orp.shape == osp.shape == (n,)
    # K3TWO_MAT: K3TWO's geometry and sub-ranges, inv, the columns and the
    # halving counter
    mat_args = lib.args[lib.calls.index("nphj_k3two_mat")]
    assert (mat_args[3], mat_args[7]) == (nbg_r, nbg_s)
    assert mat_args[8:13] == (f1, f2, cap2,
                              rho3.subranges(nbg_r + nbg_s, cap2), 7)
    assert mat_args[13:16] == tuple(t.data_ptr() for t in (ok, orp, osp))
    assert mat_args[18] == rho3.halving_counter("cpu").data_ptr()
    for rp, with_pay in ((_i32(1001), True), (None, False)):
        cnt, pay = rstats.r_cand_stats_kernel(_i32(1001), rp, _i32(64),
                                              with_pay)
        assert cnt.shape == pay.shape == (64,)
        assert cnt.dtype == pay.dtype == torch.int64
        # one (2, h) output, zeroed by the launcher, whose rows are the
        # results
        out = lib.args[len(lib.calls) - 1][5]
        assert out == cnt.data_ptr() == pay.data_ptr() - 64 * 8
    assert [n for n in lib.calls if n.startswith(("nphj", "rstats"))
            and n != "rstats_max_h"] == [
        "nphj_k3two", "nphj_k3two", "nphj_k3two_mat", "rstats", "rstats"]
    after = _counters()
    assert {k: after[k] - before[k] for k in after} == dict(
        NO_LAUNCH, K3TWO=2, K3TWO_MAT=1, RSTATS=2)


def test_nphj_and_rstats_wrappers_reject_what_the_kernels_do_not_take(lib):
    slots, cnt = _i32(2, 1, 4, 128), _i32(2, 1, 4)
    with pytest.raises(ValueError, match="both"):
        nphj.k3two(slots, slots, cnt, slots, None, cnt)
    with pytest.raises(ValueError, match="needs the payloads"):
        nphj.k3two_mat(slots, None, cnt, slots, None, cnt, 1)
    with pytest.raises(ValueError, match="shape"):
        nphj.k3two(slots, None, cnt, _i32(2, 1, 8, 128), None,
                   _i32(2, 1, 8))
    with pytest.raises(TypeError, match="int32"):
        rstats.r_cand_stats_kernel(_i32(8).long(), None, _i32(4), False)
    with pytest.raises(ValueError, match="payloads"):
        rstats.r_cand_stats_kernel(_i32(8), None, _i32(4), True)
    with pytest.raises(ValueError, match="candidates"):
        rstats.r_cand_stats_kernel(_i32(8), None, _i32(2000), False)


def test_new_wrappers_on_a_cuda_tensor_raise_without_the_kernels(
        monkeypatch, tmp_path):
    """Where no kernel can be built, a CUDA tensor makes the wrapper raise;
    it never falls back to the plain version."""
    def nvcc_missing():
        raise RuntimeError("nvcc not found")

    def plain_called(*args, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "find_nvcc", nvcc_missing)
    build.load.cache_clear()
    for mod in (nphj, rstats):
        monkeypatch.setattr(mod, "on_cuda", lambda x: True)
        monkeypatch.setattr(mod, "stream", lambda device: 0)
    for name in ("k3two_plain", "k3two_mat_plain"):
        monkeypatch.setattr(nphj, name, plain_called)
    monkeypatch.setattr(rstats, "r_cand_stats_plain", plain_called)
    slots, cnt = _i32(2, 1, 4, 128), _i32(2, 1, 4)
    before = _counters()
    try:
        for call in (lambda: nphj.k3two(slots, None, cnt, slots, None, cnt),
                     lambda: nphj.k3two_mat(slots, slots, cnt, slots, slots,
                                            cnt, 1),
                     lambda: rstats.r_cand_stats_kernel(_i32(8), _i32(8),
                                                        _i32(4))):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                call()
    finally:
        build.load.cache_clear()
    assert _counters() == before


def test_sort_wrappers_call_their_launchers_once(lib, monkeypatch):
    """sort_blocks and sort_hist: outputs in the documented shapes, one
    launcher call each, and the 64-bit work array the kernels take: none
    where a block is one tile (sub 128), n values for one merge level (sub
    256), 2n for the levels that alternate between two halves (sub 512 and
    1024)."""
    work = []

    def spy(n, sub, device):
        w = real_scratch(n, sub, device)
        work.append(w)
        return w

    real_scratch = blocksort.scratch
    monkeypatch.setattr(blocksort, "scratch", spy)
    before = _counters()
    for sub, per_n in ((128, 0), (256, 1), (512, 2), (1024, 2)):
        n = 2 * sub * 128
        key, pay = _i32(n), _i32(n)
        ok, op = blocksort.sort_blocks(key, pay, sub)
        assert ok.shape == op.shape == (n,) and ok.dtype == torch.int32
        assert blocksort.merge_levels(sub) == {128: 0, 256: 1, 512: 2,
                                               1024: 3}[sub]
        w = work[-1]
        if per_n == 0:
            assert w is None
        else:
            assert w.shape == (per_n * n,) and w.dtype == torch.int64
        assert lib.args[-1][:7] == (key.data_ptr(), pay.data_ptr(), n, sub,
                                    None if w is None else w.data_ptr(),
                                    ok.data_ptr(), op.data_ptr())
    n = 3 * 1024 * 128
    key, pay = _i32(n), _i32(n)
    ks, ps, starts = compact.sort_hist(key, pay, 0.25, 1024, 16)
    assert ks.shape == ps.shape == (3 * 1024, 128)
    assert starts.shape == (3, 17) and starts.dtype == torch.int32
    assert work[-1].shape == (2 * n,)
    assert lib.args[-1][:10] == (key.data_ptr(), pay.data_ptr(), n, 1024,
                                 16, 0.25, work[-1].data_ptr(),
                                 ks.data_ptr(), ps.data_ptr(),
                                 starts.data_ptr())
    assert len(work) == 5
    assert [n for n in lib.calls if n.startswith("sort")] == [
        "sort_blocks"] * 4 + ["sort_hist"]
    after = _counters()
    assert {k: after[k] - before[k] for k in after} == dict(
        NO_LAUNCH, sort_blocks=4, sort_hist=1)


def test_tile_plan_calls_its_launcher_once(lib):
    """tile_plan hands the launcher the inputs, the sorted outputs and six
    zeroed counters, and reads the counts back by name."""
    n = 2 * blocksort.TILE
    key, pay = _i32(n), _i32(n)
    before = _counters()
    plan = blocksort.tile_plan(key, pay)
    assert plan == dict.fromkeys(blocksort.PLAN_COUNTS, 0)
    assert lib.calls[-1] == "sort_tile_plan"
    assert lib.args[-1][:3] == (key.data_ptr(), pay.data_ptr(), n)
    after = _counters()
    assert {k: after[k] - before[k] for k in after} == dict(NO_LAUNCH,
                                                           tile_plan=1)
    with pytest.raises(ValueError, match="whole number"):
        blocksort.tile_plan(_i32(n + 128), _i32(n + 128))


def test_kernel_launches_reads_the_launchers_counts(lib):
    """kernel_launches asks the library once for its three counts and
    names them; it launches nothing and counts no wrapper call."""
    before = _counters()
    assert blocksort.kernel_launches() == dict.fromkeys(blocksort.KERNELS, 0)
    assert lib.calls == ["sort_kernel_launches"]
    assert _counters() == before


def test_sort_wrappers_reject_what_the_kernels_do_not_take(lib):
    n = 128 * 128
    with pytest.raises(ValueError, match="sub"):
        blocksort.sort_blocks(_i32(n * 2), _i32(n * 2), 192)
    with pytest.raises(ValueError, match="whole number"):
        blocksort.sort_blocks(_i32(n + 128), _i32(n + 128), 128)
    with pytest.raises(TypeError, match="int32"):
        blocksort.sort_blocks(_i32(n).long(), _i32(n), 128)
    with pytest.raises(ValueError, match="shape"):
        blocksort.sort_blocks(_i32(n), _i32(2 * n), 128)
    for F in (0, 128):
        with pytest.raises(ValueError, match="F="):
            compact.sort_hist(_i32(n), _i32(n), 0.0, 128, F)
    assert not [c for c in lib.calls if c.startswith("sort")]


def test_sort_wrappers_on_a_cuda_tensor_raise_without_the_kernels(
        monkeypatch, tmp_path):
    """Where no kernel can be built, sort_blocks and sort_hist raise on a
    CUDA tensor; they never fall back to the plain versions."""
    def nvcc_missing():
        raise RuntimeError("nvcc not found")

    def plain_called(*args, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "find_nvcc", nvcc_missing)
    build.load.cache_clear()
    for mod in (blocksort, compact):
        monkeypatch.setattr(mod, "on_cuda", lambda x: True)
        monkeypatch.setattr(mod, "stream", lambda device: 0)
    monkeypatch.setattr(blocksort, "sort_blocks_plain", plain_called)
    monkeypatch.setattr(compact, "sort_hist_plain", plain_called)
    monkeypatch.setattr(compact, "sort_blocks_plain", plain_called)
    n = 128 * 128
    before = _counters()
    try:
        for call in (lambda: blocksort.sort_blocks(_i32(n), _i32(n), 128),
                     lambda: compact.sort_hist(_i32(n), _i32(n), 0.0, 128,
                                               1)):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                call()
    finally:
        build.load.cache_clear()
    assert _counters() == before

"""The port's scans against the JAX package's, on the CPU.

The same seeded numpy columns go to both.  The JAX side runs its Pallas
scans in interpret mode at sub=256 and its compactor entries at the default
window, as tests/test_pallas_scan.py does; the port takes its plain
versions for CPU tensors.  Counts, sums and outputs must agree exactly;
sums are compared mod 2^32, since the reference's int64 is int32 without
x64 (ROADMAP "Quirks").
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.ops import scan as jscan
from aqp_tpu.ops.pallas import scan as jpscan
from aqp_tpu_torch.ops import scan as tscan
from aqp_tpu_torch.ops.kernels import lanecompact as tlc
from aqp_tpu_torch.ops.kernels import scan as tkscan

SUB = 256
N = 128 * SUB * 2               # two reference blocks
U32 = 0xFFFFFFFF
DICT_LO = (np.arange(256) * 7 + 3).astype(np.int32)
DICT_HI = (np.arange(256) * 11 - 900).astype(np.int32)


def _col(n=N, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8)


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                  t.numpy().astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(30, 200), (0, 255), (7, 7), (-5, 40),
                                   (250, 300), (90, 10)])
def test_count_sum_bitvector_pallas_match_reference(lo, hi):
    col = _col()
    j, t = jnp.asarray(col), torch.from_numpy(col)
    jlo = jnp.uint8(min(max(lo, 0), 255))
    jhi = jnp.uint8(min(max(hi, 0), 255))
    if (lo, hi) in ((-5, 40), (250, 300)):   # clamped bounds, same rows
        jlo, jhi = jnp.int32(lo), jnp.int32(hi)
    got_c = tkscan.scan_count_pallas(t, lo, hi, sub=SUB, device="cpu")
    got_s = tkscan.scan_sum_pallas(t, lo, hi, sub=SUB, device="cpu")
    got_b = tkscan.scan_bitvector_pallas(t, lo, hi, sub=SUB, device="cpu")
    assert int(got_c) == int(jpscan.scan_count_pallas(j, jlo, jhi, sub=SUB,
                                                      interpret=True))
    assert int(got_s) & U32 == int(jpscan.scan_sum_pallas(
        j, jlo, jhi, sub=SUB, interpret=True)) & U32
    _eq(jpscan.scan_bitvector_pallas(j, jlo, jhi, sub=SUB, interpret=True),
        got_b)
    keep = (col.astype(np.int64) >= lo) & (col.astype(np.int64) <= hi)
    assert int(got_c) == int(keep.sum())
    assert int(got_s) == int(col[keep].astype(np.int64).sum())
    with pytest.raises(ValueError, match="whole blocks"):
        tkscan.scan_count_pallas(t[:-1], lo, hi, sub=SUB, device="cpu")


@pytest.mark.parametrize("n", [N, 1001, 8])
def test_dense_scan_modes_match_reference(n):
    col = _col(n, seed=n)
    j, t = jnp.asarray(col), torch.from_numpy(col)
    lo, hi = 30, 200
    jlo, jhi = jnp.uint8(lo), jnp.uint8(hi)
    cap = n // 2
    assert int(tscan.scan_count(t, lo, hi, device="cpu")) == int(
        jscan.scan_count(j, jlo, jhi))
    assert int(tscan.scan_sum(t, lo, hi, device="cpu")) & U32 == int(
        jscan.scan_sum(j, jlo, jhi)) & U32
    _eq(jscan.scan_bitvector(j, jlo, jhi),
        tscan.scan_bitvector(t, lo, hi, device="cpu"))
    for jfn, tfn in ((jscan.scan_index, tscan.scan_index),
                     (jscan.scan_values, tscan.scan_values)):
        (ja, jc), (ta, tc) = jfn(j, jlo, jhi, cap), tfn(t, lo, hi, cap,
                                                        device="cpu")
        assert int(tc) == int(jc)
        _eq(ja, ta)
    dic = jnp.asarray(DICT_LO)
    ja, jc = jscan.scan_dict(j, dic, jlo, jhi, cap)
    ta, tc = tscan.scan_dict(t, torch.from_numpy(DICT_LO), lo, hi, cap,
                             device="cpu")
    assert int(tc) == int(jc)
    _eq(ja, ta)
    _eq(jscan.scan_dict_full(j, dic),
        tscan.scan_dict_full(t, torch.from_numpy(DICT_LO), device="cpu"))


@pytest.mark.parametrize("chunk", [1 << 14, 5000])
def test_scan_count_streamed_matches_reference(chunk):
    col = _col(N + 77, seed=9)
    want = int(jscan.scan_count_streamed(col, jnp.uint8(30), jnp.uint8(200),
                                         chunk=chunk))
    got = tscan.scan_count_streamed(torch.from_numpy(col), 30, 200,
                                    chunk=chunk, device="cpu")
    assert int(got) == want
    with pytest.raises(ValueError, match="on the host"):
        tscan.scan_count_streamed(torch.from_numpy(col).to("meta"), 30, 200,
                                  device="cpu")


@pytest.mark.parametrize("sel", [None, 0.1, 0.5])
@pytest.mark.parametrize("mode", ["index", "values", "dict"])
def test_write_modes_pallas_match_reference(mode, sel):
    """Block-granular outputs, position by position, at the default window
    (w = 512); a hint below the true selectivity (0.1 against 0.66) cuts
    windows and reports overflow in both."""
    col = _col(128 * 512 * 2 + 300, seed=4)
    j, t = jnp.asarray(col), torch.from_numpy(col)
    lo, hi = 30, 200
    cap = col.size // 128 + 2
    jlo, jhi = jnp.uint8(lo), jnp.uint8(hi)
    if mode == "dict":
        jd = (jnp.asarray(DICT_LO), jnp.asarray(DICT_HI))
        td = (torch.from_numpy(DICT_LO), torch.from_numpy(DICT_HI))
        jo = jpscan.scan_dict_pallas(j, *jd, jlo, jhi, cap, sel_hint=sel,
                                     interpret=True)
        to = tkscan.scan_dict_pallas(t, *td, lo, hi, cap, sel_hint=sel,
                                     device="cpu")
    else:
        jfn = getattr(jpscan, f"scan_{mode}_pallas")
        tfn = getattr(tkscan, f"scan_{mode}_pallas")
        jo = jfn(j, jlo, jhi, cap, sel_hint=sel, interpret=True)
        to = tfn(t, lo, hi, cap, sel_hint=sel, device="cpu")
    assert len(jo) == len(to)
    for a, b in zip(jo, to):
        _eq(a, b)
    ovf = int(to[-1])
    assert (ovf > 0) == (sel == 0.1)
    if not ovf:      # the live row ids are the dense form's, in order
        ids = to[0].numpy()
        live = ids < tlc.PAD_S_INPUT
        dense, cnt = tscan.scan_index(t, lo, hi, col.size, device="cpu")
        np.testing.assert_array_equal(ids[live], dense[:int(cnt)].numpy())


def test_hint_ladder_matches_reference():
    from aqp_tpu.ops.pallas import lanecompact as jlc

    assert tlc.HINT_LADDER == jlc.HINT_LADDER
    for sel in (None, 0.0, 0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.6, 0.9,
                1.0, 1.7):
        assert tlc.hint_ladder(sel) == jlc.hint_ladder(sel)


def test_range_mask_clamps_out_of_range_bounds():
    col = torch.from_numpy(_col(1000, seed=3))
    ref = col.long()
    for lo, hi in ((-5, 300), (300, 400), (-9, -1), (3, 2), (0, 255)):
        m = tscan.range_mask(col, lo, hi)
        assert torch.equal(m, (ref >= lo) & (ref <= hi))


def test_cpu_scans_launch_no_kernel():
    before = dict(tkscan.LAUNCHES), dict(tlc.LAUNCHES)
    col = torch.from_numpy(_col(5000))
    tscan.scan_count(col, 1, 9, device="cpu")
    tscan.scan_bitvector(col, 1, 9, device="cpu")
    tlc.scan_dict_fast(col, torch.from_numpy(DICT_LO),
                       torch.from_numpy(DICT_HI), 1, 9, 64, w=8)
    assert (dict(tkscan.LAUNCHES), dict(tlc.LAUNCHES)) == before

"""The port's windowed compaction against the JAX package's, on the CPU.

The JAX side runs its lane compactor in Pallas interpret mode at w=64, as
tests/test_lanecompact.py does; the port takes its plain versions for CPU
tensors.  Outputs are compared position by position, exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.ops.pallas import lanecompact as jlc
from aqp_tpu_torch.ops.kernels import lanecompact as tlc

W = 64
CASES = {
    # name: (n, fraction dropped, keep_frac, capacity rows less than needed)
    "full-window-buffers": (1 << 14, 0.6, None, 0),
    "ragged-no-cut": (3 * (1 << 13) + 17, 0.7, 0.3, 0),
    "ragged-cut": (3 * (1 << 13) + 17, 0.3, 0.3, 0),
    "capacity-truncated": (1 << 14, 0.5, None, 40),
}


def _inputs(case):
    n, drop_frac, _, _ = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 3)
    key = rng.integers(0, 1 << 20, n).astype(np.int32)
    pay = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(
        np.int32)
    key[rng.random(n) < drop_frac] = jlc.PAD_S_INPUT
    key[:5] = [-3, -(1 << 31) + 1, jlc.PAD_R_INPUT - 1, jlc.PAD_R_INPUT,
               jlc.PAD_S_INPUT]
    return key, pay


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_fast_matches_reference(case):
    n, _, kf, short = CASES[case]
    key, pay = _inputs(case)
    need = -(-int(np.sum(key < jlc.PAD_R_INPUT)) // 128)
    cap = (-(-n // 128) + 2) if not short else need - short
    jk, jp, jovf = jlc.compact_kp_fast(jnp.asarray(key), jnp.asarray(pay),
                                       cap_rows=cap, w=W, keep_frac=kf,
                                       interpret=True)
    tk, tp, tovf = tlc.compact_kp_fast(torch.from_numpy(key),
                                       torch.from_numpy(pay), cap, w=W,
                                       keep_frac=kf)
    assert int(tovf) == int(jovf)
    if case in ("ragged-cut", "capacity-truncated"):
        assert int(tovf) > 0
    else:
        assert int(tovf) == 0
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jk1, jovf1 = jlc.compact_k_fast(jnp.asarray(key), cap_rows=cap, w=W,
                                    keep_frac=kf, interpret=True)
    tk1, tovf1 = tlc.compact_k_fast(torch.from_numpy(key), cap, w=W,
                                    keep_frac=kf)
    assert int(tovf1) == int(jovf1) == int(jovf)
    np.testing.assert_array_equal(tk1.numpy(), np.asarray(jk1))
    if int(tovf) == 0:   # nothing lost: the kept keys in order
        live = tk.numpy() < jlc.PAD_R_INPUT
        np.testing.assert_array_equal(tk.numpy()[live],
                                      key[key < jlc.PAD_R_INPUT])


def test_compact_windows_counts_are_uncapped():
    key, pay = _inputs("ragged-cut")
    t = torch.from_numpy(key)
    ow = tlc.out_w_for(W, 0.3)
    blocks, counts = tlc._compact_windows(
        t, [t, torch.from_numpy(pay)], tlc.INT32_MIN + 1,
        tlc.PAD_R_INPUT - 1, W, (tlc.PAD_S_INPUT, 0), ow)
    block = W * 128
    nb = -(-key.size // block)
    want = [int(np.sum(key[i * block:(i + 1) * block] < tlc.PAD_R_INPUT))
            for i in range(nb)]
    assert counts.tolist() == want
    assert max(want) > ow * 128
    assert [tuple(b.shape) for b in blocks] == [(nb, ow, 128)] * 2


def test_out_w_for_matches_reference():
    for w in (8, 64, 512):
        for hint in (None, 0.0, 0.01, 0.02, 0.05, 0.1, 0.1875, 0.3, 0.6,
                     0.75, 1.0, 1.5):
            assert tlc.out_w_for(w, hint) == jlc.out_w_for(w, hint)


def test_cpu_compaction_launches_no_kernel():
    before = dict(tlc.LAUNCHES)
    tlc.compact_k_fast(torch.arange(1000, dtype=torch.int32), 16, w=8)
    assert tlc.LAUNCHES == before


SCAN_CASES = {
    # name: (n, dtype, sel_hint): whole windows (the reference reads bytes),
    # a ragged tail (the reference widens to int32, the port reads bytes),
    # a hint below the selectivity (windows cut), an int32 column
    "u8-whole": (3 * W * 128, np.uint8, None),
    "u8-ragged": (3 * W * 128 + 77, np.uint8, 0.6),
    "u8-cut": (3 * W * 128 + 77, np.uint8, 0.1),
    "int32": (2 * W * 128 + 5, np.int32, None),
}
DICT_LO = (np.arange(256) * 5 - 7).astype(np.int32)
DICT_HI = (np.arange(256) * -3 + 1000).astype(np.int32)


@pytest.mark.parametrize("mode", ["index", "values", "dict"])
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_fast_forms_match_reference(case, mode):
    """The compactor's scan forms (row ids; values; dictionary decode),
    position by position, with the block-granular fill between windows."""
    n, dtype, sel = SCAN_CASES[case]
    rng = np.random.default_rng(len(case) + n)
    hi_val = 256 if dtype == np.uint8 else 300
    col = rng.integers(-40 if dtype == np.int32 else 0, hi_val, n).astype(
        dtype)
    lo, hi = 20, 180
    cap = n // 128 + 4
    j, t = jnp.asarray(col), torch.from_numpy(col)
    if mode == "dict":
        jo = jlc.scan_dict_fast(j, jnp.asarray(DICT_LO), jnp.asarray(DICT_HI),
                                lo, hi, cap, w=W, sel_hint=sel,
                                interpret=True)
        to = tlc.scan_dict_fast(t, torch.from_numpy(DICT_LO),
                                torch.from_numpy(DICT_HI), lo, hi, cap, w=W,
                                sel_hint=sel)
    else:
        jo = getattr(jlc, f"scan_{mode}_fast")(j, lo, hi, cap, w=W,
                                               sel_hint=sel, interpret=True)
        to = getattr(tlc, f"scan_{mode}_fast")(t, lo, hi, cap, w=W,
                                               sel_hint=sel)
    assert len(to) == len(jo)
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b.numpy().astype(np.int64),
                                      np.asarray(a).astype(np.int64))
    ovf = int(to[-1])
    assert (ovf > 0) == (case == "u8-cut")
    if not ovf:
        ids = to[0].numpy()
        live = ids < tlc.PAD_S_INPUT
        keep = (col.astype(np.int64) >= lo) & (col.astype(np.int64) <= hi)
        np.testing.assert_array_equal(ids[live], np.nonzero(keep)[0])
        if mode == "values":
            np.testing.assert_array_equal(to[1].numpy()[live], col[keep])
        if mode == "dict":
            np.testing.assert_array_equal(to[2].numpy()[live],
                                          DICT_HI[col[keep]])


def test_scan_row_ids_are_limited_to_int32_pads():
    col = torch.empty(tlc.PAD_R_INPUT, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="row ids are int32"):
        tlc._compact_windows(col, [], 0, 9, 8, (), with_ids=True)

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

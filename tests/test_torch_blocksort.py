"""The port's block sort (B13) against the JAX package's, on the CPU.

The JAX side runs `sort_blocks(..., interpret=True)`; the port's wrapper
takes its plain version for CPU tensors.  Keys must be equal by position,
and each block must hold the same (key, payload) pairs: the reference's
bitonic network leaves equal keys in its own payload order, the port
orders them by payload as unsigned (checked on its own below).  Inputs
hold duplicate keys and KEY_PAD_INT pads.  Every comparison is exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.ops.pallas import blocksort as jbs
from aqp_tpu_torch.ops.kernels import blocksort as tbs

LANES = 128


def _inputs(n, seed):
    """Random keys, a quarter drawn from 16 values (long runs of equal
    keys), a tenth KEY_PAD_INT; random payloads."""
    rng = np.random.default_rng(seed)
    key = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    few = rng.random(n) < 0.25
    key[few] = rng.integers(0, 16, int(few.sum()))
    key[rng.random(n) < 0.1] = jbs.KEY_PAD_INT
    pay = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64)
    return key.astype(np.int32), pay.astype(np.int32)


def _pairs(k, p):
    return sorted(zip(k.tolist(), p.tolist()))


CASES = {
    # name: (sub, blocks) -- the reference's interpret mode takes ~5 s for
    # the two sub=128 blocks and ~9 s for one default block
    "sub128-2blocks": (128, 2),
    "default-1block": (jbs.SUB, 1),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def sorted_both(request):
    sub, nb = CASES[request.param]
    key, pay = _inputs(sub * LANES * nb, seed=sorted(CASES).index(
        request.param))
    jk, jp = jbs.sort_blocks(jnp.asarray(key), jnp.asarray(pay), sub=sub,
                             interpret=True)
    tk, tp = tbs.sort_blocks(torch.from_numpy(key), torch.from_numpy(pay),
                             sub=sub)
    return sub, nb, key, pay, (np.asarray(jk), np.asarray(jp)), (
        tk.numpy(), tp.numpy())


def test_keys_equal_by_position(sorted_both):
    _, _, _, _, (jk, _), (tk, _) = sorted_both
    np.testing.assert_array_equal(tk, jk)


def test_each_block_holds_the_same_pairs(sorted_both):
    sub, nb, key, pay, (jk, jp), (tk, tp) = sorted_both
    block = sub * LANES
    for b in range(nb):
        sl = slice(b * block, (b + 1) * block)
        want = _pairs(key[sl], pay[sl])
        assert _pairs(jk[sl], jp[sl]) == want
        assert _pairs(tk[sl], tp[sl]) == want


def test_ties_are_ordered_by_unsigned_payload(sorted_both):
    """The port's tie rule: within a block, (key, payload as uint32)
    ascending, so the output is a function of the block's pairs alone."""
    sub, nb, _, _, _, (tk, tp) = sorted_both
    block = sub * LANES
    comp = (tk.astype(np.int64) << 32) | (tp.astype(np.int64) & 0xFFFFFFFF)
    for b in range(nb):
        assert (np.diff(comp[b * block:(b + 1) * block]) >= 0).all()


def test_plain_version_is_one_row_sort_of_the_composite():
    key, pay = _inputs(4 * 128 * LANES, seed=9)
    tk, tp = tbs.sort_blocks_plain(torch.from_numpy(key),
                                   torch.from_numpy(pay), sub=256)
    comp = np.sort(((key.astype(np.int64) << 32)
                    | (pay.astype(np.int64) & 0xFFFFFFFF)).reshape(2, -1),
                   axis=1).reshape(-1)
    np.testing.assert_array_equal(tk.numpy(), (comp >> 32).astype(np.int32))
    np.testing.assert_array_equal(tp.numpy(), comp.astype(np.int32))


def test_all_equal_keys_sort_by_payload():
    n = 128 * LANES
    pay = np.random.default_rng(3).integers(-(1 << 31), 1 << 31, n,
                                            dtype=np.int64).astype(np.int32)
    tk, tp = tbs.sort_blocks(torch.full((n,), 5, dtype=torch.int32),
                             torch.from_numpy(pay), sub=128)
    assert (tk.numpy() == 5).all()
    np.testing.assert_array_equal(tp.numpy().view(np.uint32),
                                  np.sort(pay.view(np.uint32)))


@pytest.mark.parametrize("sub,n", [(100, 12800), (2048, 2048 * LANES),
                                   (128, 128 * LANES + 1)])
def test_unsupported_shapes_raise(sub, n):
    key = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError):
        tbs.sort_blocks(key, key, sub=sub)


def test_constants_and_layout_helpers_match():
    for name in ("LANES", "SUB", "BLOCK", "KEY_PAD_INT", "KEY_PAD"):
        assert getattr(tbs, name) == getattr(jbs, name), name
    x = np.arange(3 * 128 * LANES, dtype=np.int32)
    cm = tbs.to_colmajor(torch.from_numpy(x), 3, 128)
    np.testing.assert_array_equal(cm.numpy(),
                                  np.asarray(jbs.to_colmajor(x, 3, 128)))
    back = tbs.from_colmajor(cm, 3, 128)
    np.testing.assert_array_equal(back.numpy(), x)

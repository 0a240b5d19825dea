"""The port's segment scatter against the JAX package's, on the CPU.

The JAX side runs `scatter_segments(..., interpret=True)`, which is its
gather formulation `_scatter_reference`; the port's wrappers take their
plain versions for CPU tensors.  Both drop the last output row (the
reference's trash row), so rows [:out_rows - 1] must be equal, exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.ops.pallas import compact as jcompact
from aqp_tpu_torch.ops.kernels import compact as tcompact

LANES = 128


def _segments(rng, nseg, src_rows, out_rows, empty_frac, tail_zero):
    """Non-overlapping segments laid end to end from row 0, some empty,
    optionally the last ones of size zero, some past out_rows."""
    sz = rng.integers(1, 9, nseg)
    sz[rng.random(nseg) < empty_frac] = 0
    if tail_zero:
        sz[-3:] = 0
    doff = np.cumsum(sz) - sz
    soff = rng.integers(0, src_rows - 8, nseg)
    return [a.astype(np.int32) for a in (soff, doff, sz)]


CASES = {
    # name: (nseg, out_rows, empty_frac, tail_zero)
    "fits": (40, 400, 0.0, False),
    "empty-segments": (40, 400, 0.4, False),
    "zero-size-tail": (40, 400, 0.2, True),
    "clamped-at-capacity": (40, 60, 0.1, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scatter_segments_matches_reference(case):
    nseg, out_rows, empty_frac, tail_zero = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    src_rows = 96
    ks = rng.integers(-(1 << 31), 1 << 31, (src_rows, LANES),
                      dtype=np.int64).astype(np.int32)
    ps = rng.integers(-(1 << 31), 1 << 31, (src_rows, LANES),
                      dtype=np.int64).astype(np.int32)
    soff, doff, sz = _segments(rng, nseg, src_rows, out_rows, empty_frac,
                               tail_zero)
    if case == "clamped-at-capacity":
        assert int((doff + sz).max()) > out_rows   # some rows are cut
    fill = jcompact.PAD_S_INPUT
    jk, jp = jcompact.scatter_segments(
        jnp.asarray(ks), jnp.asarray(ps), jnp.asarray(soff),
        jnp.asarray(doff), jnp.asarray(sz), nseg, out_rows, fill_key=fill,
        interpret=True)
    t = [torch.from_numpy(a) for a in (ks, ps, soff, doff, sz)]
    tk, tp = tcompact.scatter_segments(*t, nseg, out_rows, fill_key=fill)
    assert tk.shape == tp.shape == (out_rows, LANES)
    np.testing.assert_array_equal(tk[:-1].numpy(), np.asarray(jk)[:-1])
    np.testing.assert_array_equal(tp[:-1].numpy(), np.asarray(jp)[:-1])
    # the single-array form copies the same rows
    jk1 = jcompact.scatter_segments_one(
        jnp.asarray(ks), jnp.asarray(soff), jnp.asarray(doff),
        jnp.asarray(sz), nseg, out_rows, fill_key=fill, interpret=True)
    tk1 = tcompact.scatter_segments_one(t[0], *t[2:], nseg, out_rows,
                                        fill_key=fill)
    np.testing.assert_array_equal(tk1[:-1].numpy(), np.asarray(jk1)[:-1])
    # rows no segment covers keep the fill
    covered = np.zeros(out_rows, bool)
    for d, n in zip(doff, sz):
        covered[d:d + n] = True
    assert (tk.numpy()[~covered] == fill).all()
    assert (tp.numpy()[~covered] == 0).all()


def _gapped(rng, nseg, src_rows, dead_frac):
    """Segments laid end to end with gaps (the first one not at row 0),
    some of size 0, in no order."""
    sz = rng.integers(1, 9, nseg)
    doff = np.cumsum(rng.integers(0, 5, nseg) + sz) - sz
    sz[rng.random(nseg) < dead_frac] = 0
    soff = rng.integers(0, src_rows - 8, nseg)
    order = rng.permutation(nseg)
    return [a[order].astype(np.int32) for a in (soff, doff, sz)]


GAPPED = {
    # name: (nseg, dead fraction, out_rows past the last segment's end)
    "gaps": (40, 0.0, 7),
    "gaps-dead-between": (40, 0.3, 3),
    "gaps-cut": (40, 0.1, -30),
    "no-segment": (0, 0.0, 12),
    "no-live-segment": (12, 1.0, 5),
}


@pytest.mark.parametrize("case", sorted(GAPPED))
def test_unsorted_segments_with_gaps_match_reference(case):
    """Segments in no order with gaps between them, dead ones among them,
    rows cut at out_rows, and none at all or none live: the kernel fills
    every uncovered row itself, so the plain version must agree with the
    reference's gather there too."""
    nseg, dead_frac, past = GAPPED[case]
    rng = np.random.default_rng(100 + sorted(GAPPED).index(case))
    src_rows = 64
    ks = rng.integers(-(1 << 31), 1 << 31, (src_rows, LANES),
                      dtype=np.int64).astype(np.int32)
    ps = rng.integers(-(1 << 31), 1 << 31, (src_rows, LANES),
                      dtype=np.int64).astype(np.int32)
    soff, doff, sz = _gapped(rng, nseg, src_rows, dead_frac)
    end = int((doff + sz).max()) if nseg else 0
    out_rows = end + past
    fill = jcompact.PAD_S_INPUT
    jk, jp = jcompact.scatter_segments(
        jnp.asarray(ks), jnp.asarray(ps), jnp.asarray(soff),
        jnp.asarray(doff), jnp.asarray(sz), nseg, out_rows, fill_key=fill,
        interpret=True)
    t = [torch.from_numpy(a) for a in (ks, ps, soff, doff, sz)]
    tk, tp = tcompact.scatter_segments(*t, nseg, out_rows, fill_key=fill)
    np.testing.assert_array_equal(tk[:-1].numpy(), np.asarray(jk)[:-1])
    np.testing.assert_array_equal(tp[:-1].numpy(), np.asarray(jp)[:-1])
    tk1 = tcompact.scatter_segments_one(t[0], *t[2:], nseg, out_rows,
                                        fill_key=fill)
    np.testing.assert_array_equal(tk1.numpy(), tk.numpy())
    if case.startswith("no-"):
        assert (tk.numpy() == fill).all() and not tp.numpy().any()


def test_constants_match():
    for name in ("PAD_R_INPUT", "PAD_S_INPUT", "KEY_PAD_INT"):
        assert getattr(tcompact, name) == getattr(jcompact, name), name


def test_cpu_scatter_launches_no_kernel():
    before = dict(tcompact.LAUNCHES)
    ks = torch.zeros((4, LANES), dtype=torch.int32)
    d = torch.zeros(1, dtype=torch.int32)
    tcompact.scatter_segments_one(ks, d, d, d + 2, 1, 5)
    assert tcompact.LAUNCHES == before

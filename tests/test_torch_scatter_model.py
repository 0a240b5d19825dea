"""A CPU model of the segment scatter's kernel (csrc/compact.cu,
scatter_kernel), step for step, held exactly against the port's plain
version (compact.scatter_segments_plain), for one array
(scatter_segments_one) and for two (scatter_segments).

The model follows the kernel's arithmetic:
  grid    chunk = clamp(ceil(out_rows / (4 * wave)), 16, 1024) output
          rows a CTA, ceil(out_rows / chunk) CTAs, wave = 132 SMs x 4;
  map     each CTA's shared map of its chunk, -1 (fill) first; then one
          pass over the segment list, lane l of warp w taking segments
          base + q * 256 + l, q = 0..3 loaded together, base = w * 32,
          + 1,024, ...: a lane's segment is live when sz > 0 and 0 <= doff
          < out_rows, and meets the chunk on [max(doff, r0), min(doff + sz,
          r1)); for each q the ballot's lanes in order, the whole warp
          writing each such segment's source rows (soff + row - doff,
          clamped to [0, src_rows)) into the map, 32 rows a step;
  copy    warp w takes chunk rows w, w + 8, ..., four rows loaded (a
          source row, or the fill: fill_key for the key, 0 for the
          payload) before any is stored, a lane per 16-byte vector.
Every output vector is counted as it is written (each exactly once) and
every map entry as it is set (at most once: segments do not overlap).
"""

import numpy as np
import pytest
import torch

from aqp_tpu_torch.ops.kernels import compact

LANES = 128
VEC = LANES // 4
FILL = -7


def model_scatter(arrays, soff, doff, sz, out_rows, fill_key, nt=256,
                  wave=132 * 4, min_chunk=16, max_chunk=1024, in_flight=4):
    """The kernel on numpy (src_rows, 128) arrays.  Returns the outputs,
    the writes of each output vector and the CTAs' count."""
    src_rows = arrays[0].shape[0]
    nseg = soff.size
    warps = nt // 32
    chunk = min(max(-(-out_rows // (4 * wave)), min_chunk), max_chunk)
    grid = -(-out_rows // chunk)
    outs = [np.zeros((out_rows, LANES), np.int32) for _ in arrays]
    writes = np.zeros((out_rows, VEC), np.int64)
    vec_rows = [x.reshape(src_rows, VEC, 4) for x in arrays]
    for b in range(grid):
        r0 = b * chunk
        r1 = min(r0 + chunk, out_rows)
        rows = r1 - r0
        smap = [-1] * rows
        set_count = [0] * rows
        for w in range(warps):
            for base, q in ((b0, q) for b0 in range(w * 32, nseg, 4 * nt)
                            for q in range(4)):
                lo, hi, s = [0] * 32, [0] * 32, [0] * 32
                for lane in range(32):
                    i = base + q * nt + lane
                    if i >= nseg:
                        continue
                    n, d = int(sz[i]), int(doff[i])
                    if n > 0 and 0 <= d < out_rows:
                        lo[lane] = max(d, r0)
                        hi[lane] = min(d + n, r1)
                        s[lane] = int(soff[i]) + lo[lane] - d
                for l in (l for l in range(32) if lo[l] < hi[l]):
                    a, e, s0 = lo[l], hi[l], s[l]
                    for step in range(a, e, 32):
                        for lane in range(32):
                            r = step + lane
                            if r < e:
                                x = min(max(s0 + r - a, 0), src_rows - 1)
                                smap[r - r0] = x
                                set_count[r - r0] += 1
        assert max(set_count, default=0) <= 1
        for w in range(warps):
            for r in range(w, rows, warps * in_flight):
                for u in range(in_flight):
                    rr = r + u * warps
                    if rr >= rows:
                        continue
                    src = smap[rr]
                    for k, x in enumerate(vec_rows):
                        fill = fill_key if k == 0 else 0
                        row = (x[src].reshape(LANES) if src >= 0
                               else np.full(LANES, fill, np.int32))
                        outs[k][r0 + rr] = row
                    writes[r0 + rr] += 1
    return outs, writes, grid


def check(arrays, soff, doff, sz, out_rows, **kw):
    """Model == scatter_segments_plain; every output vector written once."""
    got, writes, grid = model_scatter(arrays, soff, doff, sz, out_rows, FILL,
                                      **kw)
    assert (writes == 1).all()
    want = compact.scatter_segments_plain(
        [torch.from_numpy(x) for x in arrays], *(torch.from_numpy(t) for t in
                                                 (soff, doff, sz)),
        out_rows, FILL)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x.numpy())
    return grid


def source(src_rows, seed, two=True):
    rng = np.random.default_rng(seed)
    return [rng.integers(-2**31, 2**31, (src_rows, LANES)).astype(np.int32)
            for _ in range(2 if two else 1)]


def laid_out(rng, nseg, src_rows, gap_max, size_max=9, dead_frac=0.0):
    """Segments laid end to end with random gaps (the first one not at row
    0), some dead (sz 0 or negative), then shuffled."""
    sz = rng.integers(1, size_max + 1, nseg)
    gaps = rng.integers(0, gap_max + 1, nseg)
    doff = np.cumsum(gaps + sz) - sz
    dead = rng.random(nseg) < dead_frac
    sz[dead] = rng.integers(-3, 1, int(dead.sum()))
    soff = rng.integers(0, src_rows, nseg)
    order = rng.permutation(nseg)
    return [a[order].astype(np.int32) for a in (soff, doff, sz)]


@pytest.mark.parametrize("two", [True, False], ids=["pair", "one"])
@pytest.mark.parametrize("case", ["gaps", "dead", "cut", "tail-gap"])
def test_unsorted_segments_at_the_kernel_geometry(case, two):
    """256 threads, four waves of 528 CTAs: unsorted segments with gaps,
    dead segments between live ones, a cut at out_rows, and a long gap
    after the last live segment (as the z = 1.5 residual's output)."""
    rng = np.random.default_rng(["gaps", "dead", "cut", "tail-gap"]
                                .index(case))
    arrays = source(300, seed=1, two=two)
    soff, doff, sz = laid_out(rng, 200, 300, gap_max=4,
                              dead_frac=0.3 if case == "dead" else 0.0)
    end = int((doff + np.maximum(sz, 0)).max())
    out_rows = {"gaps": end + 1, "dead": end + 5, "cut": end * 2 // 3,
                "tail-gap": 2 * end}[case]
    grid = check(arrays, soff, doff, sz, out_rows)
    assert grid == -(-out_rows // max(-(-out_rows // 2112), 16))


@pytest.mark.parametrize("wave,nt", [(3, 64), (7, 32), (1, 256)])
def test_segments_spanning_many_chunks(wave, nt):
    """A few CTAs of small chunks: long segments cross chunk edges, more
    segments than a warp's 4 x 32 a step, a first live segment far from
    row 0."""
    rng = np.random.default_rng(wave)
    arrays = source(500, seed=2)
    soff, doff, sz = laid_out(rng, 300, 500, gap_max=30, size_max=60,
                              dead_frac=0.2)
    doff = doff + 37
    out_rows = int((doff + np.maximum(sz, 0)).max()) + 11
    check(arrays, soff, doff, sz, out_rows, nt=nt, wave=wave, min_chunk=4,
          max_chunk=64)


def test_chunks_at_their_most_rows():
    """An output of many chunks of 1,024 rows (more rows than a wave of
    16-row chunks covers)."""
    rng = np.random.default_rng(5)
    arrays = source(200, seed=3, two=False)
    soff, doff, sz = laid_out(rng, 40, 200, gap_max=300, size_max=200)
    out_rows = int((doff + sz).max()) + 500
    assert check(arrays, soff, doff, sz, out_rows, wave=1) == -(-out_rows
                                                               // 1024)


def test_dead_starts_and_clamped_sources():
    """Starts below 0 or at and past out_rows copy nothing; sources
    before row 0 and past the last row are clamped."""
    arrays = source(20, seed=4)
    soff = np.array([-5, 15, 0, 3, 2, 18], np.int32)
    doff = np.array([2, 30, -4, 40, 50, 10], np.int32)
    sz = np.array([6, 8, 10, 3, 5, 9], np.int32)
    check(arrays, soff, doff, sz, 40, wave=3, min_chunk=4)


@pytest.mark.parametrize("out_rows", [1, 5, 16, 33])
def test_no_live_segment_fills_everything(out_rows):
    arrays = source(8, seed=out_rows)
    check(arrays, np.zeros(3, np.int32), np.array([0, 3, out_rows], np.int32),
          np.array([0, -1, 4], np.int32), out_rows)
    check(arrays, *(np.zeros(0, np.int32),) * 3, out_rows)


def test_one_segment_covering_the_output():
    arrays = source(64, seed=6)
    one = np.array([0], np.int32)
    check(arrays, one, one, np.array([64], np.int32), 64, wave=2,
          min_chunk=8)

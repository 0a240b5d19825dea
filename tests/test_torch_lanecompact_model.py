"""A CPU model of the window compactor's kernel (csrc/lanecompact.cu,
compact_windows_kernel), step for step, held exactly against the port's
plain version (lanecompact.compact_windows_plain).

The model follows the kernel's arithmetic for each window (one CTA of
`nt` threads):
  head       the (16 - o) % 16 bytes before the column's first 16-byte
             boundary (o = data_ptr % 16, the same in every window, since
             windows start 128 elements apart), read one an element: one
             ballot, ranks from 0;
  tiles      the window's whole 16-byte vectors after the head, `nt` x `u`
             of them a tile, vector u * nt + t of a tile to thread t; each
             vector's keep bits (16 for bytes, from x - lo <= hi - lo
             byte by byte, none when [lo, hi] misses [0, 255]; 4 for int32);
  ranks      a thread's u vector counts packed in 16-bit fields of one
             64-bit word, an inclusive warp scan by doubling (shfl_up), the
             warp totals summed in order (the CTA's scan); a warp's first
             rank in vector row u is the count carried from earlier tiles
             plus field u of (the earlier warps' totals + the earlier rows'
             totals);
  writes     each warp stages its kept elements of row u in rank order (a
             thread walks its set bits, a byte's entry carrying its value),
             then writes them out at consecutive positions, stopping at
             `cap`;
  tail       the elements past the last whole vector, one an element;
  fill       [min(count, cap), cap) of every output: single elements up to
             a multiple of 4, then groups of 4 (16-byte stores).
Every output position is counted as it is written: each exactly once.
The kernel runs 256 threads and 4 vectors a thread (a tile of 16,384
bytes or 4,096 int32); the tests also run them scaled down, so that a
window spans many tiles.
"""

import numpy as np
import pytest
import torch

from aqp_tpu_torch.ops.kernels import lanecompact as lc

LANES = 128
M64 = (1 << 64) - 1
DICT_LO = (np.arange(256) * 5 - 7).astype(np.int32)
DICT_HI = (np.arange(256) * -3 + 1000).astype(np.int32)


def dict_entry(x):
    return (128 if x >= 128 else 0) + (x & 127)


def keep_bits(vec, lo, hi, itemsize):
    """The kernel's keep bits of one 16-byte vector (element i at bit i)."""
    bits = 0
    if itemsize == 1:
        l8, h8 = max(lo, 0), min(hi, 255)
        if l8 > h8:
            return 0
        for i, x in enumerate(vec):
            bits |= int((int(x) - l8) % 256 <= h8 - l8) << i
    else:
        for i, x in enumerate(vec):
            bits |= int(lo <= int(x) <= hi) << i
    return bits


def set_bits(m):
    i = 0
    while m:
        if m & 1:
            yield i
        m >>= 1
        i += 1


def field(word, u):
    return (word >> (16 * u)) & 0xFFFF


def model_windows(col, o, lo, hi, w, ow, kinds, srcs, fills, tables=None,
                  nt=256, u_n=4):
    """The kernel on numpy column `col` whose data starts o bytes past a
    16-byte boundary.  kinds: each output's kind (lanecompact OUT_*), srcs:
    the payload array of each OUT_ARRAY output.  Returns (list of (nb, ow,
    128) outputs, counts, the writes of each output position)."""
    itemsize = col.itemsize
    assert o % itemsize == 0
    vec = 16 // itemsize
    n = col.size
    block, cap = w * LANES, ow * LANES
    nb = -(-n // block)
    head = (16 - o) % 16 // itemsize
    nwarps = nt // 32
    outs = [np.zeros(nb * cap, np.int64) for _ in kinds]
    writes = np.zeros((len(kinds), nb * cap), np.int64)
    counts = np.zeros(nb, np.int64)

    def put(pos, gi, x):
        for k, kind in enumerate(kinds):
            if kind == lc.OUT_ROW_ID:
                val = gi
            elif kind == lc.OUT_ARRAY:
                val = int(srcs[k][gi])
            elif kind == lc.OUT_VALUE:
                val = x
            else:
                val = int(tables[kind - lc.OUT_DICT_LO][dict_entry(x)])
            outs[k][pos] = val
            writes[k, pos] += 1

    for win in range(nb):
        base = win * block
        length = min(block, n - base)
        ob = win * cap

        def edge(e0, e1, r0):
            # one ballot; every warp takes it alike, warp 0 writes
            assert e1 - e0 <= 31
            kept = [e for e in range(e0, e1)
                    if lo <= int(col[base + e]) <= hi]
            for r, e in enumerate(kept, r0):
                if r < cap:
                    put(ob + r, base + e, int(col[base + e]))
            return len(kept)

        hh = min(head, length)
        running = edge(0, hh, 0)
        nvec = (length - hh) // vec
        tile = nt * u_n
        for t0 in range(0, nvec, tile):
            mk = np.zeros((nt, u_n), np.int64)    # each vector's keep bits
            data = {}
            for t in range(nt):
                for u in range(u_n):
                    vi = t0 + u * nt + t
                    if vi < nvec:
                        e = hh + vi * vec
                        # a whole aligned vector inside the window
                        assert (o + (base + e) * itemsize) % 16 == 0
                        assert e + vec <= length
                        data[t, u] = col[base + e:base + e + vec]
                        mk[t, u] = keep_bits(data[t, u], lo, hi, itemsize)
            c = [sum(bin(int(mk[t, u])).count("1") << (16 * u)
                     for u in range(u_n)) for t in range(nt)]
            inc = list(c)
            for wp in range(nwarps):       # warp scans by doubling
                lanes = inc[32 * wp:32 * wp + 32]
                d = 1
                while d < 32:
                    lanes = [lanes[i] + (lanes[i - d] if i >= d else 0)
                             for i in range(32)]
                    d *= 2
                inc[32 * wp:32 * wp + 32] = lanes
            wtot = [inc[32 * wp + 31] for wp in range(nwarps)]
            tot = sum(wtot) & M64
            for t in range(nt):
                for u in range(u_n):      # no field overflows
                    assert field(inc[t], u) < 1 << 16
            row_pre = (tot * 0x0001000100010000) & M64
            for wp in range(nwarps):
                w_rank = (sum(wtot[:wp]) + row_pre) & M64
                for u in range(u_n):
                    wb = running + field(w_rank, u)
                    lim = min(field(wtot[wp], u), cap - wb)
                    if lim <= 0:
                        continue
                    stage = {}
                    for t in range(32 * wp, 32 * wp + 32):
                        r = field(inc[t] - c[t], u)
                        et = (u * nt + t) * vec
                        for i in set_bits(int(mk[t, u])):
                            if r >= lim:
                                break
                            assert r not in stage
                            stage[r] = (et + i, int(data[t, u][i]))
                            r += 1
                    assert sorted(stage) == list(range(lim))
                    for j in range(lim):
                        et, x = stage[j]
                        put(ob + wb + j, base + hh + t0 * vec + et, x)
            running += (tot * 0x0001000100010001 & M64) >> 48
        running += edge(hh + nvec * vec, length, running)
        kept = min(running, cap)
        a4 = min(cap, (kept + 3) & ~3)
        for k, kind in enumerate(kinds):
            if kind in (lc.OUT_DICT_LO, lc.OUT_DICT_HI):
                fill = int(tables[kind - lc.OUT_DICT_LO][0])
            else:
                fill = fills[k]
            spans = [range(kept, a4)] + [range(p * 4, p * 4 + 4)
                                         for p in range(a4 // 4, cap // 4)]
            for span in spans:
                for p in span:
                    outs[k][ob + p] = fill
                    writes[k, ob + p] += 1
        counts[win] = running
    return ([x.astype(np.int32).reshape(nb, ow, LANES) for x in outs],
            counts.astype(np.int32), writes)


# (kinds' builder) the forms: _compact_windows' keyword arguments
FORMS = {
    "index": dict(with_ids=True),
    "values": dict(with_ids=True, with_values=True),
    "dict": dict(with_ids=True, dict_tables=True),
    "key+payload": dict(payloads=2),
    "key": dict(payloads=1),
    "ids+payload": dict(with_ids=True, payloads=1),
    "payload+values": dict(payloads=1, with_values=True),
    "payload+dict": dict(payloads=1, dict_tables=True),
}


def run_form(form, col, o, lo, hi, w, ow, nt=256, u_n=4, seed=0):
    """Model == compact_windows_plain for one form; every position written
    once.  Returns the counts."""
    spec = dict(FORMS[form])
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(-(1 << 31), 1 << 31, col.size).astype(np.int32)
                for _ in range(spec.get("payloads", 0))]
    if payloads and col.dtype == np.int32:
        payloads[0] = col      # the join passes its key column itself
    fills = tuple(int(f) for f in rng.integers(-9, 9, len(payloads)
                                               + int(bool(spec.get(
                                                   "with_values")))))
    tables = ((DICT_LO, DICT_HI) if spec.get("dict_tables") else None)
    kw = dict(with_ids=spec.get("with_ids", False),
              with_values=spec.get("with_values", False),
              dict_tables=None if tables is None
              else tuple(torch.from_numpy(t) for t in tables))
    want, want_counts = lc.compact_windows_plain(
        torch.from_numpy(col), [torch.from_numpy(p) for p in payloads], lo,
        hi, w, fills, ow, **kw)
    outputs = lc._outputs(payloads, fills, kw["with_ids"], kw["with_values"],
                          tables)
    kinds = [k for k, _, _ in outputs]
    srcs = [a for _, a, _ in outputs]
    got, counts, writes = model_windows(col, o, lo, hi, w, ow, kinds, srcs,
                                        [f for _, _, f in outputs], tables,
                                        nt, u_n)
    assert (writes == 1).all()
    np.testing.assert_array_equal(counts, want_counts.numpy())
    assert len(got) == len(want)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x.numpy())
    return counts


def byte_col(n, seed, runs=False):
    """Random bytes, or (runs) the scan benchmark's arange & 255 pattern,
    whose kept bytes come in runs."""
    if runs:
        return (np.arange(n) & 255).astype(np.uint8)
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8)


@pytest.mark.parametrize("form", ["index", "values", "dict"])
@pytest.mark.parametrize("o", range(16))
def test_byte_column_at_every_misalignment(o, form):
    """uint8 columns starting 0-15 bytes past a 16-byte boundary, n ragged,
    scaled-down tiles (a window of 8 rows spans 8 tiles)."""
    col = byte_col(3 * 1024 + 77 + o, seed=o)
    run_form(form, col, o, 30, 180, 8, 8, nt=32, u_n=2, seed=o)


@pytest.mark.parametrize("form", ["index", "values", "dict", "key+payload",
                                  "key", "ids+payload", "payload+values",
                                  "payload+dict"])
@pytest.mark.parametrize("o", [0, 4, 8, 12])
def test_int32_column_at_every_misalignment(o, form):
    """int32 columns 0, 4, 8 or 12 bytes past a 16-byte boundary, n ragged,
    every form (the join's and the mixed ones included)."""
    rng = np.random.default_rng(o + 50)
    col = rng.integers(-60, 300, 2 * 1024 + 13).astype(np.int32)
    run_form(form, col, o, 0, 200, 8, 8, nt=32, u_n=2, seed=o)


@pytest.mark.parametrize("o", [0, 5, 15])
@pytest.mark.parametrize("form", ["index", "values", "dict"])
def test_windows_cut_where_a_run_of_kept_bytes_passes_cap(form, o):
    """The arange & 255 column (runs of kept bytes) at a selectivity above
    the output block: windows are cut at cap, counts stay uncapped."""
    col = byte_col(4 * 1024 + 300, seed=0, runs=True)
    counts = run_form(form, col, o, 0, 120, 8, 2, nt=64, u_n=2)
    assert (counts > 2 * LANES).any()


@pytest.mark.parametrize("lo,hi", [(0, 255), (250, 400), (9, 3), (-5, 20),
                                   (256, 300)])
def test_byte_ranges_clamped_and_empty(lo, hi):
    """Ranges past a byte's: clamped to [0, 255], or keeping nothing."""
    col = byte_col(1024 + 33, seed=3)
    run_form("values", col, 3, lo, hi, 8, 8, nt=32, u_n=1)


@pytest.mark.parametrize("nt,u_n", [(256, 4), (64, 2), (32, 1)])
def test_kernel_tile_and_scaled_down_tiles(nt, u_n):
    """The kernel's tile (256 threads x 4 vectors: a 64-row window of bytes
    is half a tile) and smaller ones, over several windows, with a short
    last window of fewer elements than the head."""
    col = byte_col(64 * LANES * 3 + 9, seed=7)
    run_form("dict", col, 9, 17, 99, 64, 16, nt=nt, u_n=u_n)
    col32 = np.random.default_rng(8).integers(0, 1 << 20, 16 * LANES * 2 + 2)
    run_form("key+payload", col32.astype(np.int32), 8, 1000, 700_000, 16, 8,
             nt=nt, u_n=u_n)


def test_windows_shorter_than_the_head():
    """n below the head's length: the whole column is one short head."""
    for n in (1, 5, 14):
        run_form("index", byte_col(n, seed=n), 1, 0, 255, 8, 8, nt=32,
                 u_n=1)
    run_form("key", np.arange(3, dtype=np.int32), 4, 0, 9, 8, 8, nt=32,
             u_n=1)

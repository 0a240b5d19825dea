"""A CPU model of the sub-range region join behind K3 and K3TWO
(csrc/region_join.cuh, subrange_join_kernel), step for step, held exactly
against the port's plain versions (rho3.k3_plain, nphj.k3two_plain).

The model follows the kernel's arithmetic for each CTA, one (region, key
sub-range p) of P:
  interval   the region's smallest and largest key, from the first and last
             real element of each run (table and probe);
  bounds     the interval cut into P equal widths at even packed keys (the
             first sub-range starts at the smallest key rounded down to
             even, the last ends past the largest), so S key k and its
             partner k - 1 fall on the same side;
  pieces     each run's positions of the piece [A, B) by lower_bound of A
             and of B over its real elements (A at or below the smallest
             key is position 0, B past the largest the run's count);
  R pass     each table run's positions in run order; an even key is kept
             when it differs from its predecessor in the run (the first,
             lowest-payload copy); past `rcap` kept keys the piece is cut in
             two at an even key, the left half done first and the right one
             stacked (a halving);
  merge      the runs that kept something, merged pairwise level by level,
             ties to the left (lower) run;
  directory  the piece's key span cut into at most `ndir` buckets of
             2^sh keys; dir[t] is the first merged key at or past bucket
             t's start;
  S pass     each odd key of each probe run's piece: lower_bound of key - 1
             among its bucket's merged keys; a hit counts, and with
             payloads adds the answering R payload and its own, mod 2^32.
K3 is the model with the union's runs as table and probe; K3TWO with the
table's runs and S's.  K3M is K3 whose S pass writes, for every element of
each piece it reads (R or S, a piece that kept no R included), its own
position of K2's layout: a matched S element ((packed >> 1) * inv mod
2^30, R payload, S payload), any other element (-3, 0, 0); the positions
past each slot's count are holes split evenly among the region's P CTAs
(the q-th CTA writes [c + (cap2 - c) q / P, c + (cap2 - c) (q + 1) / P)
of a slot of count c), an empty region's too, so every position is written
exactly once.  K3TWO_MAT is K3TWO with K3M's S pass, at nphj's layout:
region (a, b) owns the chunk [(a * f2 + b) * w, + w), w = 2 * max(nbg_r,
nbg_s) * cap2, and S run j's slot position e is written at chunk + j *
cap2 + e; the holes are each S slot's [count, cap2) and the chunk's tail
past the S runs (w / cap2 - nbg_s more chunks of cap2), split evenly among
the P CTAs in the same way, and a piece whose table runs hold nothing in
its range still writes its S elements.  The kernel's rcap is 4,096 R keys
(SR_RCAP) and its ndir 4,096 buckets (SR_DIR); the tests also run them
scaled down, so that pieces halve, down to one key, and buckets hold many
keys.
"""

import numpy as np
import pytest
import torch

from aqp_tpu_torch.ops.kernels import nphj, rho3

U32 = 0xFFFFFFFF
KEY_PAD_INT = rho3.KEY_PAD_INT
INV = rho3._modinv_pow2(rho3.HASH_C)
RCAP = 4096   # the kernel's R keys a CTA
NDIR = 4096   # the kernel's directory buckets


def sub_bounds(kmin, kmax, p, P):
    """Sub-range p of P of the interval [kmin, kmax]: [A, B), both even."""
    width = kmax - kmin + 1
    a = kmin & ~1 if p == 0 else (kmin + p * width // P) & ~1
    b = (kmax & ~1) + 2 if p == P - 1 else (kmin + (p + 1) * width // P) & ~1
    return a, b


def run_piece(keys, A, B, kmin, kmax):
    """Positions [lo, hi) of the piece [A, B) in one run's real keys."""
    lo = 0 if A <= kmin else int(np.searchsorted(keys, A, side="left"))
    hi = keys.size if B > kmax else int(np.searchsorted(keys, B,
                                                        side="left"))
    return lo, hi


def directory(rk, A, B, ndir):
    """(sh, dir): buckets of 2^sh keys over [A, B), at most ndir of them,
    and dir[t] = the first of the sorted keys rk at or past A + (t << sh)
    (dir[-1] = rk.size)."""
    span = B - A
    sh = 0
    while (span - 1) >> sh >= ndir:
        sh += 1
    nd = ((span - 1) >> sh) + 1
    return sh, np.searchsorted(rk, A + (np.arange(nd + 1) << sh),
                               side="left")


def lookup(rk, A, sh, dirs, want):
    """Position of each wanted key among its bucket's keys (lower_bound)
    and whether it is there."""
    bw = (want - A) >> sh
    lo, hi = dirs[bw], dirs[bw + 1]
    pos = np.clip(np.searchsorted(rk, want, side="left"), lo, hi)
    hit = pos < hi
    hit[hit] = rk[pos[hit]] == want[hit]
    return pos, hit


def merge(x, y):
    """Merge two (keys, payloads) runs sorted by key, x's first on ties."""
    keys = np.concatenate([x[0], y[0]])
    order = np.argsort(keys, kind="stable")
    return keys[order], np.concatenate([x[1], y[1]])[order]


def region_runs(k, p, cnt, a, b):
    """A region's runs as (keys int64, payloads uint32) of real elements."""
    out = []
    for i in range(k.shape[1]):
        c = int(cnt[a, i, b])
        keys = k[a, i, b, :c].astype(np.int64)
        pays = (np.zeros(c, np.int64) if p is None
                else p[a, i, b, :c].astype(np.int64) & U32)
        out.append((keys, pays))
    return out


def model_region(table, probe, same, P, rcap, ndir, emit=None):
    """One region's (matches, checksum sum, halvings) over its P CTAs.

    emit(i, lo, hit, r_pay), where given (K3M, K3TWO_MAT), receives each
    probe run i's stretch [lo, lo + hit.size) of each piece the S pass
    reads, a piece that kept no R, or whose table runs hold nothing in its
    range, included: whether each element matched and the answering R
    payload (0 where it did not)."""
    runs = table if same else table + probe
    real = [r[0] for r in runs if r[0].size]
    if not real:
        return 0, 0, 0
    kmin = min(int(r[0]) for r in real)
    kmax = max(int(r[-1]) for r in real)
    m = c = halvings = 0
    for part in range(P):
        A, B = sub_bounds(kmin, kmax, part, P)
        stack = []
        while True:
            if A < B:
                t_pos = [run_piece(r[0], A, B, kmin, kmax) for r in table]
                s_pos = t_pos if same else [run_piece(r[0], A, B, kmin, kmax)
                                            for r in probe]
                vt = sum(h - lo for lo, h in t_pos)
                vp = sum(h - lo for lo, h in s_pos)
                # MAT (emit): a piece whose table runs hold nothing still
                # writes its S
                if vp > 0 and (vt > 0 or emit is not None):
                    subruns = []
                    for (keys, pays), (lo, h) in zip(table, t_pos):
                        kk, pp = keys[lo:h], pays[lo:h]
                        first = np.ones(kk.size, bool)
                        first[1:] = kk[1:] != kk[:-1]
                        keep = (kk % 2 == 0) & first
                        subruns.append((kk[keep], pp[keep]))
                    kept = sum(s[0].size for s in subruns)
                    if kept > rcap:
                        stack.append(B)
                        halvings += 1
                        B = A + (((B - A) >> 2) << 1)
                        continue
                    level = [s for s in subruns if s[0].size]
                    while len(level) > 1:
                        level = [merge(level[q], level[q + 1])
                                 if q + 1 < len(level) else level[q]
                                 for q in range(0, len(level), 2)]
                    rk, rp = level[0] if level else (np.zeros(0, np.int64),
                                                     np.zeros(0, np.int64))
                    sh, dirs = directory(rk, A, B, ndir)
                    for i, ((keys, pays), (lo, h)) in enumerate(zip(probe,
                                                                     s_pos)):
                        kk, pp = keys[lo:h], pays[lo:h]
                        odd = kk % 2 == 1
                        hit_all = np.zeros(kk.size, bool)
                        r_pay = np.zeros(kk.size, np.int64)
                        if rk.size and odd.any():
                            at, hit = lookup(rk, A, sh, dirs, kk[odd] - 1)
                            m += int(hit.sum())
                            c += int((rp[at[hit]] + pp[odd][hit]).sum())
                            hit_all[np.flatnonzero(odd)[hit]] = True
                            r_pay[hit_all] = rp[at[hit]]
                        if emit is not None:
                            emit(i, lo, hit_all, r_pay)
            if not stack:
                break
            A, B = B, stack.pop()
    return m, c, halvings


def model_join(tk, tp, tcnt, sk, sp, scnt, same, P, rcap=RCAP,
               ndir=NDIR):
    """(matches, checksum, halvings) of the sub-range join over numpy slot
    arrays; `same`: K3 (the table is the probe), else K3TWO."""
    f1, _, f2, _ = tk.shape
    m = c = h = 0
    for a in range(f1):
        for b in range(f2):
            table = region_runs(tk, tp, tcnt, a, b)
            probe = table if same else region_runs(sk, sp, scnt, a, b)
            rm, rc, rh = model_region(table, probe, same, P, rcap, ndir)
            m, c, h = m + rm, c + rc, h + rh
    return m, (c & U32) if tp is not None else 0, h


# ---------------------------------------------------------------------------
# Inputs


def fill_slots(f1, nbg, f2, cap2, contents):
    """Slot arrays from contents[(a, j, b)] = (keys, payloads): each slot's
    real elements sorted by (key, payload as unsigned), pads behind."""
    k = np.full((f1, nbg, f2, cap2), KEY_PAD_INT, np.int32)
    p = np.zeros((f1, nbg, f2, cap2), np.int32)
    cnt = np.zeros((f1, nbg, f2), np.int32)
    for (a, j, b), (keys, pays) in contents.items():
        keys = np.asarray(keys, np.int64)
        pays = np.asarray(pays, np.int64)
        assert keys.size <= cap2 and (keys >= 0).all()
        order = np.lexsort((pays & U32, keys))
        n = keys.size
        k[a, j, b, :n] = keys[order]
        p[a, j, b, :n] = pays[order].astype(np.int32)
        cnt[a, j, b] = n
    return k, p, cnt


def random_slots(rng, f1, nbg, f2, cap2, n_r, n_s, domain, r_runs=None,
                 s_runs=None, dup_r=False, hit=0.7):
    """Random R (even) and S (odd) packed keys in each region's own key
    range, R in runs r_runs (default all), S in s_runs; S keys hit an R
    key of their region with probability `hit`."""
    r_runs = range(nbg) if r_runs is None else r_runs
    s_runs = range(nbg) if s_runs is None else s_runs
    contents = {}
    for a in range(f1):
        for b in range(f2):
            base = (a * f2 + b) * domain
            sig = (rng.integers(0, domain // 2, n_r) if dup_r
                   else rng.choice(domain, n_r, replace=False))
            r_keys = 2 * (base + sig)
            pick = rng.choice(r_keys, n_s) + 1 if n_r else np.zeros(0, int)
            miss = 2 * (base + rng.integers(0, domain, n_s)) + 1
            s_keys = np.where(rng.random(n_s) < hit, pick, miss) if n_r \
                else miss
            for j in range(nbg):
                contents[(a, j, b)] = ([], [])
            for keys, runs in ((r_keys, r_runs), (s_keys, s_runs)):
                if not len(runs):
                    continue
                at = rng.choice(list(runs), keys.size)
                for j in set(at.tolist()):
                    sel = keys[at == j]
                    old_k, old_p = contents[(a, j, b)]
                    contents[(a, j, b)] = (
                        list(old_k) + sel.tolist(),
                        list(old_p) + rng.integers(-(1 << 31), 1 << 31,
                                                   sel.size).tolist())
    return fill_slots(f1, nbg, f2, cap2, contents)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def plain_k3(k, p, cnt):
    return tuple(int(x) for x in rho3.k3_plain(_t(k), _t(p), _t(cnt)))


def plain_k3two(tk, tp, tcnt, sk, sp, scnt):
    return tuple(int(x) for x in nphj.k3two_plain(
        _t(tk), _t(tp), _t(tcnt), _t(sk), _t(sp), _t(scnt)))


def check_k3(k, p, cnt, P=None, rcap=RCAP, ndir=NDIR):
    """Model == k3_plain, keys-only and with payloads; returns halvings."""
    P = P or rho3.subranges(k.shape[1], k.shape[3])
    halvings = []
    for pay in (None, p):
        m, c, h = model_join(k, pay, cnt, k, pay, cnt, True, P, rcap, ndir)
        assert (m, c) == plain_k3(k, pay, cnt)
        halvings.append(h)
    assert halvings[0] == halvings[1]
    return halvings[0]


def check_k3two(tk, tp, tcnt, sk, sp, scnt, P=None, rcap=RCAP, ndir=NDIR):
    """Model == k3two_plain, keys-only and with payloads; returns
    halvings."""
    P = P or rho3.subranges(tk.shape[1] + sk.shape[1], tk.shape[3])
    halvings = []
    for tpay, spay in ((None, None), (tp, sp)):
        m, c, h = model_join(tk, tpay, tcnt, sk, spay, scnt, False, P, rcap,
                             ndir)
        assert (m, c) == plain_k3two(tk, tpay, tcnt, sk, spay, scnt)
        halvings.append(h)
    assert halvings[0] == halvings[1]
    return halvings[0]


# (f1, f2, cap2) of the geometries: SMALL_GEOM-like, PHT_o's f2 = 8 with
# 16,384-element fine slots, the skew residual's kd = 128 (f1 cut)
GEOMS = {"small": (20, 4, 2048), "f2=8 kd=128": (3, 8, 16384),
         "kd=128": (3, 16, 16384)}


def _routed(prm, nr, ns, seed, dup_r=False):
    """K2's fine slots of a packed union of R and S, through the plain
    pipeline (k1_plain, k2_plain), as numpy arrays."""
    rng = np.random.default_rng(seed)
    rk = (rng.integers(1, 1 << 12, nr) if dup_r
          else rng.choice(1 << 28, nr, replace=False) + 1)
    sk = np.where(rng.random(ns) < 0.7, rng.choice(rk, ns),
                  rng.integers(1, 1 << 28, ns))
    pays = rng.integers(-(1 << 31), 1 << 31, nr + ns)
    key = torch.from_numpy(np.concatenate([rk, sk]).astype(np.int32))
    tag = torch.cat([torch.zeros(nr, dtype=torch.int32),
                     torch.ones(ns, dtype=torch.int32)])
    packed, alias = rho3.pack_keys(key, tag, rho3.HASH_C)
    pay = torch.from_numpy(pays.astype(np.int32))
    k2k, k2p, cnt2, _, ovf = rho3.route_2level(packed, pay, prm, True)
    assert int(alias) == 0 and int(ovf) == 0
    return k2k.numpy(), k2p.numpy(), cnt2.numpy()


ROUTED = {
    # SMALL_GEOM (chip_smoke.py): one run a region at a size it holds
    "small": (rho3.Rho3Params(block_rows=128, slot_rows=8, f1=20, f2=4,
                              kd_slot_rows=16), 12_000, 1),
    # the same with 8,192-element fine slots: 2 runs a region
    "small kd=64": (rho3.Rho3Params(block_rows=128, slot_rows=8, f1=20,
                                    f2=4, kd_slot_rows=64), 60_000, 2),
    # f2 = 8 and kd = 128, cut to small blocks: 8 runs a region
    "f2=8 kd=128": (rho3.Rho3Params(block_rows=128, slot_rows=32, f1=8,
                                    f2=8, kd_slot_rows=128), 60_000, 8),
}


@pytest.mark.parametrize("dup_r", [False, True], ids=["unique", "dupR"])
@pytest.mark.parametrize("geom", list(ROUTED))
def test_model_equals_plain_on_routed_slots(geom, dup_r):
    """The model on the pipeline's own fine slots, at the wrapper's P, a
    larger P and a scaled-down R array."""
    prm, nr, runs = ROUTED[geom]
    k, p, cnt = _routed(prm, nr, 4 * nr, seed=5, dup_r=dup_r)
    assert k.shape[1] == runs
    assert check_k3(k, p, cnt) == 0
    check_k3(k, p, cnt, P=13, ndir=8)
    # few distinct R keys with dupR: an array of max(runs, 8) halves too
    assert check_k3(k, p, cnt, P=2, rcap=max(runs, 8) if dup_r else 64) > 0


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("rcap", [RCAP, 32], ids=["rcap4096", "rcap32"])
def test_model_equals_plain_with_duplicate_r_keys(geom, rcap):
    """Duplicate R keys across runs and within a run: the first run's
    lowest-payload copy answers."""
    f1, f2, cap2 = GEOMS[geom]
    rng = np.random.default_rng(11)
    k, p, cnt = random_slots(rng, f1, 4, f2, cap2, 300, 900, 400,
                             dup_r=True)
    slot_r = k[0, 1, 0, :cnt[0, 1, 0]]
    assert (np.diff(slot_r[slot_r % 2 == 0]) == 0).any()
    h = check_k3(k, p, cnt, P=3, rcap=rcap, ndir=rcap // 8)
    assert (h > 0) == (rcap == 32)
    tk, tp, tcnt = random_slots(rng, f1, 3, f2, cap2, 300, 0, 400,
                                dup_r=True)
    sk, sp, scnt = random_slots(rng, f1, 5, f2, cap2, 0, 900, 400)
    # S keys that hit the table: R key + 1 of the same region
    for a in range(f1):
        for b in range(f2):
            r = np.concatenate([tk[a, j, b, :tcnt[a, j, b]]
                                for j in range(3)])
            for j in range(5):
                c = scnt[a, j, b]
                take = rng.random(c) < 0.7
                s = sk[a, j, b, :c].copy()
                s[take] = rng.choice(r, int(take.sum())) + 1
                order = np.lexsort((sp[a, j, b, :c].astype(np.int64) & U32,
                                    s))
                sk[a, j, b, :c] = s[order]
                sp[a, j, b, :c] = sp[a, j, b, :c][order]
    check_k3two(tk, tp, tcnt, sk, sp, scnt, P=2, rcap=rcap)


def test_one_key_repeated_past_the_array_halves_down_to_one_key():
    """One R key 5,000 times (within runs and across all 8 of them) among
    dense neighbours: with an array of 8 keys the pieces halve until one
    holds that key alone (its 8 first copies, one a run)."""
    rng = np.random.default_rng(3)
    nbg, heavy = 8, 2 * 5000
    contents = {}
    for j in range(nbg):
        keys = [heavy] * 625 + list(range(heavy - 40, heavy + 42, 2))
        keys += [x + 1 for x in range(heavy - 40, heavy + 42, 2)]
        contents[(0, j, 0)] = (keys, rng.integers(-(1 << 31), 1 << 31,
                                                  len(keys)))
    k, p, cnt = fill_slots(1, nbg, 1, 1024, contents)
    h = check_k3(k, p, cnt, P=1, rcap=nbg)
    assert h >= 5
    # the piece that holds the heavy key alone: one key, nbg copies
    table = region_runs(k, p, cnt, 0, 0)
    assert sum(int((r[0] == heavy).any()) for r in table) == nbg


def test_keys_on_sub_range_edges_and_the_region_ends():
    """R keys at every cut and the region's first key, S keys at every
    cut + 1, cut - 1 (partner cut - 2) and the region's last key."""
    kmin, kmax, P = 1000, 1000 + 997, 7
    cuts = [sub_bounds(kmin, kmax, q, P)[0] for q in range(1, P)]
    r = [kmin] + cuts + [c - 2 for c in cuts] + [kmax - 1]
    s = [c + 1 for c in cuts] + [c - 1 for c in cuts] + [kmin + 1, kmax]
    assert kmax % 2 == 1 and all(c % 2 == 0 for c in cuts)
    rng = np.random.default_rng(4)
    contents = {(0, 0, 0): (r[:5] + s[:4], rng.integers(0, 99, 9)),
                (0, 1, 0): (r[5:] + s[4:], rng.integers(0, 99, len(r[5:])
                                                         + len(s[4:])))}
    k, p, cnt = fill_slots(1, 2, 1, 64, contents)
    assert check_k3(k, p, cnt, P=P) == 0
    assert plain_k3(k, None, cnt)[0] == len(s)
    tk, tp, tcnt = fill_slots(1, 1, 1, 64, {(0, 0, 0): (r, np.arange(len(r)))})
    sk, sp, scnt = fill_slots(1, 2, 1, 64, {
        (0, 0, 0): (s[:6], np.arange(6)),
        (0, 1, 0): (s[6:], np.arange(len(s) - 6))})
    check_k3two(tk, tp, tcnt, sk, sp, scnt, P=P)
    check_k3two(tk, tp, tcnt, sk, sp, scnt, P=P, rcap=2, ndir=2)


@pytest.mark.parametrize("geom", list(GEOMS))
def test_empty_slots_all_r_all_s_regions_and_more_table_runs(geom):
    """Empty slots and regions, regions of R only and of S only, and a
    table of more runs than S (K3TWO)."""
    f1, f2, cap2 = GEOMS[geom]
    rng = np.random.default_rng(8)
    k, p, cnt = random_slots(rng, f1, 4, f2, cap2, 200, 600, 1000,
                             r_runs=[0, 1], s_runs=[1, 2, 3])
    cnt[0, :, 0] = 0            # an empty region
    cnt[1, 0, 1] = 0            # an empty slot
    cnt[2, 1:, 2] = np.minimum(cnt[2, 1:, 2], 0)   # region 2,2: R run only
    k_r = k.copy()
    cnt_r = cnt.copy()
    cnt_r[:, 2:, :] = 0         # every region R and S of runs 0, 1 only
    for kk, cc in ((k, cnt), (k_r, cnt_r)):
        check_k3(kk, p, cc)
        check_k3(kk, p, cc, P=5, rcap=16)
    tk, tp, tcnt = random_slots(rng, f1, 6, f2, cap2, 300, 0, 1000)
    sk, sp, scnt = random_slots(rng, f1, 2, f2, cap2, 0, 500, 1000)
    scnt[0, :, 1] = 0           # no S in a region
    tcnt[1, :, 0] = 0           # no R in a region
    assert check_k3two(tk, tp, tcnt, sk, sp, scnt) == 0
    assert check_k3two(tk, tp, tcnt, sk, sp, scnt, P=4, rcap=32) > 0


def test_subranges_at_the_headline_and_the_skew_geometries():
    """The wrapper's P: K3 8 and K3TWO 10 sub-ranges a region at the
    headline (nbg 16, table 4, cap2 8,192), 16 and 20 at cap2 16,384."""
    assert rho3.subranges(16, 8192) == 8
    assert rho3.subranges(4 + 16, 8192) == 10
    assert rho3.subranges(16, 16384) == 16
    assert rho3.subranges(4 + 16, 16384) == 20
    assert rho3.subranges(1, 1024) == 1


def test_sub_range_bounds_cut_at_even_keys_and_cover_the_interval():
    for kmin, kmax, P in ((0, 1, 1), (3, 3, 4), (7, 2 ** 31 - 2, 20),
                          (1000, 1997, 7), (6, 9, 16)):
        bounds = [sub_bounds(kmin, kmax, q, P) for q in range(P)]
        assert bounds[0][0] <= kmin and bounds[-1][1] > kmax
        for (a0, b0), (a1, _) in zip(bounds, bounds[1:]):
            assert b0 == a1
        assert all(a % 2 == 0 and b % 2 == 0 and a <= b for a, b in bounds)


@pytest.mark.parametrize("ndir", [NDIR, 64, 2])
def test_directory_narrows_each_lookup_to_its_bucket(ndir):
    """At most ndir buckets of 2^sh keys cover the piece; each key's
    lower_bound among all merged keys lies in its bucket's range, so the
    bucket search finds what a search of the whole array finds."""
    rng = np.random.default_rng(9)
    for A, B in ((1000, 1000 + 2 * 997), (0, 2), (6, 2 ** 31)):
        rk = np.unique(rng.integers(A // 2, B // 2, 300)) * 2
        sh, dirs = directory(rk, A, B, ndir)
        assert dirs.size - 1 <= ndir and (B - A - 1) >> sh < dirs.size - 1
        assert dirs[0] == 0 and dirs[-1] == rk.size
        want = np.concatenate([rk, rk + 2, rng.integers(A, B, 500)])
        want = want[(want >= A) & (want < B)]
        pos, hit = lookup(rk, A, sh, dirs, want)
        glob = np.searchsorted(rk, want, side="left")
        assert (pos == glob).all()
        assert (hit == np.isin(want, rk)).all()


# ---------------------------------------------------------------------------
# K3M: the materializing S pass


def _i32(u):
    """Unsigned 32-bit values (int64) as their int32 bits."""
    return (np.asarray(u, np.int64) & U32).astype(np.uint32).view(np.int32)


def model_k3m(k, p, cnt, inv, P, rcap=RCAP, ndir=NDIR):
    """K3M from the model: (matches, checksum, key, r_payload, s_payload
    columns, the writes of each position, halvings)."""
    f1, nbg, f2, cap2 = k.shape
    cols = [np.zeros(k.size, np.int64) for _ in range(3)]
    writes = np.zeros(k.size, np.int64)

    def put(q, *vals):
        for col, val in zip(cols, vals):
            col[q] = val
        np.add.at(writes, q, 1)

    m = c = halvings = 0
    for a in range(f1):
        for b in range(f2):
            runs = region_runs(k, p, cnt, a, b)

            def slot(i):
                return ((a * nbg + i) * f2 + b) * cap2

            def emit(i, lo, hit, r_pay):
                keys, pays = (x[lo:lo + hit.size] for x in runs[i])
                orig = ((keys >> 1) * inv) & rho3.HASH_MASK
                put(slot(i) + lo + np.arange(hit.size),
                    np.where(hit, orig, -3), np.where(hit, r_pay, 0),
                    np.where(hit, pays, 0))

            rm, rc, rh = model_region(runs, runs, True, P, rcap, ndir, emit)
            m, c, halvings = m + rm, c + rc, halvings + rh
            for part in range(P):     # the holes no element owns
                for i in range(nbg):
                    n = int(cnt[a, i, b])
                    e0 = n + (cap2 - n) * part // P
                    e1 = n + (cap2 - n) * (part + 1) // P
                    put(slot(i) + np.arange(e0, e1), -3, 0, 0)
    return (m, c & U32, *(_i32(col) for col in cols), writes, halvings)


def check_k3m(k, p, cnt, inv=INV, P=None, rcap=RCAP, ndir=NDIR):
    """Model == k3m_plain, every column, with every position written once;
    the same halvings as K3's model.  Returns the halvings."""
    P = P or rho3.subranges(k.shape[1], k.shape[3])
    m, c, ok, orp, osp, writes, h = model_k3m(k, p, cnt, inv, P, rcap, ndir)
    assert (writes == 1).all()
    want = rho3.k3m_plain(_t(k), _t(p), _t(cnt), inv)
    assert (m, c) == (int(want[0]), int(want[1]))
    for got, col in zip((ok, orp, osp), want[2:]):
        np.testing.assert_array_equal(got, col.numpy())
    assert h == model_join(k, p, cnt, k, p, cnt, True, P, rcap, ndir)[2]
    return h


@pytest.mark.parametrize("dup_r", [False, True], ids=["unique", "dupR"])
@pytest.mark.parametrize("geom", list(ROUTED))
def test_k3m_model_equals_plain_on_routed_slots(geom, dup_r):
    """K3M's model on the pipeline's own fine slots: R elements, matched
    and unmatched S and the slots' tails, at the wrapper's P, a larger P
    with few directory buckets, and a scaled-down R array (halving)."""
    prm, nr, _ = ROUTED[geom]
    k, p, cnt = _routed(prm, nr, 4 * nr, seed=6, dup_r=dup_r)
    assert check_k3m(k, p, cnt) == 0
    check_k3m(k, p, cnt, P=13, ndir=8)
    assert check_k3m(k, p, cnt, P=2, rcap=max(k.shape[1], 8) if dup_r
                     else 64) > 0


def test_k3m_model_on_the_range_route():
    """MWAY's range route (salt 1, the range scale): inv = 1, regions hold
    ascending key ranges."""
    prm = ROUTED["small kd=64"][0]
    rng = np.random.default_rng(12)
    rk = rng.choice(1 << 20, 30_000, replace=False) + 1
    sk = np.where(rng.random(90_000) < 0.7, rng.choice(rk, 90_000),
                  rng.integers(1, 1 << 20, 90_000))
    key = torch.from_numpy(np.concatenate([rk, sk]).astype(np.int32))
    tag = torch.cat([torch.zeros(rk.size, dtype=torch.int32),
                     torch.ones(sk.size, dtype=torch.int32)])
    packed, _ = rho3.pack_keys(key, tag, 1)
    scale = prm.gmax / float(int(key.max()) + 1) * (1 - 1e-6)
    pay = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, key.numel())
                           .astype(np.int32))
    k2k, k2p, cnt2, _, ovf = rho3.route_2level(packed, pay, prm, True,
                                               scale=scale)
    assert int(ovf) == 0 and rho3._modinv_pow2(1) == 1
    check_k3m(k2k.numpy(), k2p.numpy(), cnt2.numpy(), inv=1)
    assert check_k3m(k2k.numpy(), k2p.numpy(), cnt2.numpy(), inv=1, P=3,
                     rcap=32) > 0


@pytest.mark.parametrize("geom", list(GEOMS))
def test_k3m_model_writes_holes_where_no_r_is(geom):
    """Pieces that keep no R (regions of S only, S runs apart from the R
    runs), an empty region and an empty slot: their elements and tails
    are holes, written once."""
    f1, f2, cap2 = GEOMS[geom]
    rng = np.random.default_rng(13)
    k, p, cnt = random_slots(rng, f1, 4, f2, cap2, 200, 600, 1000,
                             r_runs=[0, 1], s_runs=[1, 2, 3])
    cnt[0, :, 0] = 0            # an empty region
    cnt[1, 0, 1] = 0            # an empty slot
    cnt[2, :2, 2] = 0           # region (2, 2): S only
    check_k3m(k, p, cnt)
    assert check_k3m(k, p, cnt, P=5, rcap=16, ndir=4) > 0
    sk, sp, scnt = random_slots(rng, f1, 3, f2, cap2, 0, 500, 1000)
    assert plain_k3(sk, sp, scnt)[0] == 0     # no R anywhere
    check_k3m(sk, sp, scnt, P=3)


def test_k3m_model_on_one_key_repeated_past_the_array():
    """One R key 5,000 times among dense neighbours: the pieces halve
    down to the key alone, and each half writes its positions once."""
    rng = np.random.default_rng(14)
    nbg, heavy = 8, 2 * 5000
    contents = {}
    for j in range(nbg):
        keys = [heavy] * 625 + list(range(heavy - 40, heavy + 42, 2))
        keys += [x + 1 for x in range(heavy - 40, heavy + 42, 2)]
        keys += [heavy + 1] * 30
        contents[(0, j, 0)] = (keys, rng.integers(-(1 << 31), 1 << 31,
                                                  len(keys)))
    k, p, cnt = fill_slots(1, nbg, 1, 1024, contents)
    assert check_k3m(k, p, cnt, P=1, rcap=nbg) >= 5
    assert check_k3m(k, p, cnt, P=3, rcap=nbg, ndir=2) > 0


# ---------------------------------------------------------------------------
# K3TWO_MAT: the materializing S pass at nphj's layout


def model_k3two_mat(tk, tp, tcnt, sk, sp, scnt, inv, P, rcap=RCAP,
                    ndir=NDIR):
    """K3TWO_MAT from the model: (matches, checksum, key, r_payload,
    s_payload columns, the writes of each position, halvings)."""
    f1, nbg_r, f2, cap2 = tk.shape
    nbg_s = sk.shape[1]
    w = nphj.mat_chunk(nbg_r, nbg_s, cap2)
    n = f1 * f2 * w
    cols = [np.zeros(n, np.int64) for _ in range(3)]
    writes = np.zeros(n, np.int64)

    def put(q, *vals):
        for col, val in zip(cols, vals):
            col[q] = val
        np.add.at(writes, q, 1)

    m = c = halvings = 0
    for a in range(f1):
        for b in range(f2):
            table = region_runs(tk, tp, tcnt, a, b)
            probe = region_runs(sk, sp, scnt, a, b)
            chunk = (a * f2 + b) * w

            def emit(j, lo, hit, r_pay):
                keys, pays = (x[lo:lo + hit.size] for x in probe[j])
                orig = ((keys >> 1) * inv) & rho3.HASH_MASK
                put(chunk + j * cap2 + lo + np.arange(hit.size),
                    np.where(hit, orig, -3), np.where(hit, r_pay, 0),
                    np.where(hit, pays, 0))

            rm, rc, rh = model_region(table, probe, False, P, rcap, ndir,
                                      emit)
            m, c, halvings = m + rm, c + rc, halvings + rh
            for part in range(P):     # the holes: S slots' tails, the tail
                for j in range(w // cap2):
                    cnt = int(scnt[a, j, b]) if j < nbg_s else 0
                    e0 = cnt + (cap2 - cnt) * part // P
                    e1 = cnt + (cap2 - cnt) * (part + 1) // P
                    put(chunk + j * cap2 + np.arange(e0, e1), -3, 0, 0)
    return (m, c & U32, *(_i32(col) for col in cols), writes, halvings)


def check_k3two_mat(tk, tp, tcnt, sk, sp, scnt, inv=INV, P=None, rcap=RCAP,
                    ndir=NDIR):
    """Model == k3two_mat_plain, every column, with every position written
    once; the same halvings as K3TWO's model.  Returns the halvings."""
    P = P or rho3.subranges(tk.shape[1] + sk.shape[1], tk.shape[3])
    m, c, ok, orp, osp, writes, h = model_k3two_mat(tk, tp, tcnt, sk, sp,
                                                    scnt, inv, P, rcap, ndir)
    assert (writes == 1).all()
    want = nphj.k3two_mat_plain(_t(tk), _t(tp), _t(tcnt), _t(sk), _t(sp),
                                _t(scnt), inv)
    assert (m, c) == (int(want[0]), int(want[1]))
    for got, col in zip((ok, orp, osp), want[2:]):
        np.testing.assert_array_equal(got, col.numpy())
    assert h == model_join(tk, tp, tcnt, sk, sp, scnt, False, P, rcap,
                           ndir)[2]
    return h


def two_sides(rng, f1, nbg_r, nbg_s, f2, cap2, n_r, n_s, domain,
              dup_r=False, hit=0.7):
    """Table slots of R keys (even) in nbg_r runs and S slots of S keys
    (odd) in nbg_s runs, each region's keys in its own range; an S key
    hits an R key of its region with probability `hit`."""
    tc, sc = {}, {}
    for a in range(f1):
        for b in range(f2):
            base = (a * f2 + b) * domain
            sig = (rng.integers(0, domain // 2, n_r) if dup_r
                   else rng.choice(domain, n_r, replace=False))
            r_keys = 2 * (base + sig)
            miss = 2 * (base + rng.integers(0, domain, n_s)) + 1
            s_keys = (np.where(rng.random(n_s) < hit,
                               rng.choice(r_keys, n_s) + 1, miss)
                      if n_r else miss)
            for keys, nbg, out in ((r_keys, nbg_r, tc), (s_keys, nbg_s, sc)):
                at = rng.integers(0, max(nbg, 1), keys.size)
                for j in range(nbg):
                    sel = keys[at == j]
                    out[(a, j, b)] = (sel, rng.integers(-(1 << 31), 1 << 31,
                                                        sel.size))
    return (*fill_slots(f1, nbg_r, f2, cap2, tc),
            *fill_slots(f1, nbg_s, f2, cap2, sc))


# (nbg_r, nbg_s): more S runs (the headline's 4 / 16), more table runs
# (the tail longer than the S runs), equal counts
RUN_COUNTS = {"4/16": (4, 16), "6/2": (6, 2), "3/3": (3, 3)}


@pytest.mark.parametrize("rcap", [RCAP, 32], ids=["rcap4096", "rcap32"])
@pytest.mark.parametrize("runs", list(RUN_COUNTS))
def test_k3two_mat_model_equals_plain(runs, rcap):
    """K3TWO_MAT's model against k3two_mat_plain at nbg_r < nbg_s,
    nbg_r > nbg_s and equal counts, unique and duplicate R keys; at rcap
    32 the pieces halve."""
    nbg_r, nbg_s = RUN_COUNTS[runs]
    rng = np.random.default_rng(nbg_r * 10 + nbg_s)
    for dup_r in (False, True):
        sides = two_sides(rng, 3, nbg_r, nbg_s, 4, 256, 150, 450, 400,
                          dup_r=dup_r)
        tk, tp, tcnt = sides[:3]
        if dup_r:
            r = tk[0, :, 0][tk[0, :, 0] != KEY_PAD_INT]
            assert np.unique(r).size < r.size
        h = check_k3two_mat(*sides, P=3, rcap=rcap, ndir=rcap // 8)
        assert (h > 0) == (rcap == 32)


@pytest.mark.parametrize("runs", list(RUN_COUNTS))
def test_k3two_mat_model_writes_holes_where_no_r_or_no_s_is(runs):
    """An empty region, a region whose table is empty (its S elements are
    all holes), a region whose S is empty (its chunk is all holes), an
    empty S slot and pieces whose table runs hold nothing in their range
    (R and S keys in disjoint halves of a region)."""
    nbg_r, nbg_s = RUN_COUNTS[runs]
    rng = np.random.default_rng(20 + nbg_r)
    tk, tp, tcnt, sk, sp, scnt = two_sides(rng, 3, nbg_r, nbg_s, 4, 256,
                                           120, 400, 600)
    tcnt[0, :, 0] = scnt[0, :, 0] = 0     # an empty region
    tcnt[1, :, 1] = 0                     # no table in a region
    scnt[2, :, 2] = 0                     # no S in a region
    scnt[1, 0, 3] = 0                     # an empty S slot
    # region (2, 0): R in the low half of its keys, S in the high half
    for j in range(nbg_r):
        c = int(tcnt[2, j, 0])
        tk[2, j, 0, :c] = np.sort(tk[2, j, 0, :c] // 2 // 2 * 2)
    for j in range(nbg_s):
        c = int(scnt[2, j, 0])
        sk[2, j, 0, :c] = np.sort((sk[2, j, 0, :c] // 2 + 600) | 1)
    check_k3two_mat(tk, tp, tcnt, sk, sp, scnt)
    check_k3two_mat(tk, tp, tcnt, sk, sp, scnt, P=5, rcap=16, ndir=4)


@pytest.mark.parametrize("nbg_r,nbg_s", [(0, 3), (3, 0)],
                         ids=["no table runs", "no S runs"])
def test_k3two_mat_model_without_runs_on_one_side(nbg_r, nbg_s):
    """No table runs: every S element is a hole; no S runs: every chunk is
    all holes (w = 2 * nbg_r * cap2)."""
    rng = np.random.default_rng(30 + nbg_r)
    sides = two_sides(rng, 2, nbg_r, nbg_s, 3, 128, 50, 150, 300)
    check_k3two_mat(*sides)
    check_k3two_mat(*sides, P=4)


def _routed_two(prm, nr, ns, seed):
    """The table's and S's fine slots as nphj builds and routes them (the
    plain pipeline), as numpy arrays."""
    rng = np.random.default_rng(seed)
    rk = rng.choice(1 << 26, nr, replace=False) + 1
    sk = np.where(rng.random(ns) < 0.7, rng.choice(rk, ns),
                  rng.integers(1, 1 << 26, ns))
    rp, sp = (torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n)
                               .astype(np.int32)) for n in (nr, ns))
    rk, sk = (torch.from_numpy(x.astype(np.int32)) for x in (rk, sk))
    tk2, tp2, tcnt, t_ovf = nphj.nphj_build(rk, rp, prm)
    sk2, sp2, scnt, s_ovf = nphj._route_s(sk, sp, prm, rho3.HASH_C, True)
    assert int(t_ovf) == int(s_ovf) == 0
    return tuple(x.numpy() for x in (tk2, tp2, tcnt, sk2, sp2, scnt))


@pytest.mark.parametrize("nr,ns", [(4096, 1 << 18), (1 << 18, 4096)],
                         ids=["S-more-runs", "R-more-runs"])
def test_k3two_mat_model_on_routed_slots(nr, ns):
    """The model on nphj's own slots (tests/test_torch_nphj.py's geometry,
    both run orders), at the wrapper's P and with pieces halving."""
    prm = rho3.Rho3Params(block_rows=64, slot_rows=8, f1=16, f2=4,
                          kd_slot_rows=16)
    sides = _routed_two(prm, nr, ns, seed=nr + ns)
    nbg_r, nbg_s = sides[0].shape[1], sides[3].shape[1]
    assert (nbg_r < nbg_s) == (nr < ns)
    check_k3two_mat(*sides)
    assert check_k3two_mat(*sides, P=2, rcap=32, ndir=8) > 0

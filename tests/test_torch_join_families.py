"""The port's CHT, NL, INL and cracking joins (CRKJ, CrkJoin, CRKJF, CRKJS)
against the JAX package's, on the CPU, through both run_join calls.

The same seeded numpy relations go to both packages (tests/
test_torch_join.py's 4,096 x 16,384 fk and nondense kinds).  Counts and
checksums are integers and must agree exactly; materialized columns must
have the same length and the same live (key, R payload, S payload)
multiset.  Where the reference is wrong (NL's tile pads, the cracking
join's windowed form on keys outside R's domain, an empty R in CHT and
INL) the port is held to a brute-force numpy truth instead.  The file
takes about 25 s on one worker of this repository's CPU test run.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.config import JoinConfig as JConfig
from aqp_tpu.joins import api as japi
from aqp_tpu.joins import sortmerge as jsortmerge
from aqp_tpu.relation import Relation as JRelation
from aqp_tpu_torch.config import JoinConfig as TConfig
from aqp_tpu_torch.joins import api as tapi
from aqp_tpu_torch.joins import sortmerge as tsortmerge
from aqp_tpu_torch.ops import mergejoin as tmergejoin
from aqp_tpu_torch.relation import Relation as TRelation

NR, NS = 4096, 16384
NAMES = ("CHT", "NL", "INL", "CRKJ", "CrkJoin", "CRKJF", "CRKJS")
CRACKING = ("CRKJ", "CrkJoin", "CRKJF", "CRKJS")
U32 = 0xFFFFFFFF
# 64-row partitions: the cracking joins crack 6, 5 and 4 levels of R's
# 4,096 keys (CRKJ / CrkJoin, CRKJF, CRKJS); the other names ignore it
PARTITION_ROWS = 64


def _arrays(kind, seed=11):
    rng = np.random.default_rng(seed)
    if kind == "nondense":
        rk = rng.choice(1 << 28, NR, replace=False) + 1
        sk = np.where(rng.random(NS) < 0.6, rng.choice(rk, NS),
                      rng.integers(1, 1 << 28, NS))
    else:
        rk = rng.permutation(NR) + 1
        sk = np.concatenate([rng.permutation(NR) + 1
                             for _ in range(NS // NR)])
    rp = rng.integers(-(1 << 31), 1 << 31, NR, dtype=np.int64)
    sp = rng.integers(-(1 << 31), 1 << 31, sk.size, dtype=np.int64)
    return [a.astype(np.int32) for a in (rk, rp, sk, sp)]


def _both(rk, rp, sk, sp):
    j = (JRelation(jnp.asarray(rk), jnp.asarray(rp)),
         JRelation(jnp.asarray(sk), jnp.asarray(sp)))
    t = (TRelation.from_numpy(rk, rp, device="cpu"),
         TRelation.from_numpy(sk, sp, device="cpu"))
    return j, t


def _pair(res):
    return int(res.matches), int(res.checksum)


def _live(res):
    key = np.asarray(res.key)
    live = key != -3
    return sorted(zip(key[live].tolist(),
                      np.asarray(res.r_payload)[live].tolist(),
                      np.asarray(res.s_payload)[live].tolist()))


def _truth(rk, rp, sk, sp):
    """Brute force: (matches, checksum) over every (R, S) pair of equal
    keys, and the live rows of a unique-R materialized join."""
    matches, ck, rows = 0, 0, []
    for key, s_pay in zip(sk.tolist(), sp.tolist()):
        for r_pay in rp[rk == key].tolist():
            matches += 1
            ck += (r_pay & U32) + (s_pay & U32)
            rows.append((key, r_pay, s_pay))
    return matches, ck & U32, sorted(rows)


def _truth_fast(rk, rp, sk, sp):
    """_truth for unique R keys, by a dictionary."""
    at = {k: p for k, p in zip(rk.tolist(), rp.tolist())}
    rows = sorted((k, at[k], p) for k, p in zip(sk.tolist(), sp.tolist())
                  if k in at)
    ck = sum((r & U32) + (s & U32) for _, r, s in rows) & U32
    return len(rows), ck, rows


FORMS = {"checksummed": {}, "keys-only": {"checksum": False},
         "materialize": {"materialize": True}}
CASES = [(name, kind, form, prof) for name in NAMES
         for kind in ("fk", "nondense") for form in FORMS
         for prof in (False, True)]


@pytest.mark.parametrize(
    "name,kind,form,prof", CASES,
    ids=[f"{n}-{k}-{f}{'-profile' if p else ''}" for n, k, f, p in CASES])
def test_run_join_matches_reference(name, kind, form, prof):
    arrays = _arrays(kind)
    (jr, js), (tr, ts) = _both(*arrays)
    fields = dict(FORMS[form], profile_phases=prof,
                  partition_rows=PARTITION_ROWS)
    tres, tt = tapi.run_join(tr, ts, name, TConfig(**fields), device="cpu")
    assert tres.matches.dtype == torch.int64
    assert 0 <= int(tres.checksum) <= U32
    assert tt.rows_in == NR + NS and tt.matches == int(tres.matches)
    if kind == "nondense" and prof and name in CRACKING:
        # the reference's windows drop every key above 2^key_bits (here
        # all of them): held to the truth
        m, ck, rows = _truth_fast(*arrays)
        assert _pair(tres) == (m, ck)
        if form == "materialize":
            assert _live(tres) == rows
        return
    jres, _ = japi.run_join(jr, js, name, JConfig(**fields))
    assert _pair(tres) == _pair(jres)
    if kind == "fk":
        assert int(tres.matches) == NS
    if form == "materialize":
        assert tres.key.numel() == np.asarray(jres.key).size
        assert _live(tres) == _live(jres)


def test_registers_the_reference_names():
    assert sorted(tapi.JOIN_ALGORITHMS) == sorted(japi.JOIN_ALGORITHMS)
    assert len(tapi.JOIN_ALGORITHMS) == 20


def test_cht_on_a_sparse_domain_takes_sortmerge(monkeypatch):
    """nondense R keys reach 2^28: the domain passes 16 * |R|."""
    calls = []
    sortmerge = tsortmerge._sortmerge

    def spy(*args):
        calls.append(args[2])
        return sortmerge(*args)

    monkeypatch.setattr(tsortmerge, "_sortmerge", spy)
    arrays = _arrays("nondense")
    _, (tr, ts) = _both(*arrays)
    res, _ = tapi.run_join(tr, ts, "CHT", TConfig(), device="cpu")
    assert len(calls) == 1
    assert _pair(res) == _truth_fast(*arrays)[:2]
    _, (tr, ts) = _both(*_arrays("fk"))
    tapi.run_join(tr, ts, "CHT", TConfig(), device="cpu")
    assert len(calls) == 1          # the dense domain builds the table


def test_defer_then_finalize():
    (jr, js), (tr, ts) = _both(*_arrays("nondense"))
    want = _pair(japi.run_join(jr, js, "INL", JConfig())[0])
    cfg = TConfig(defer=True)
    res, t = tapi.run_join(tr, ts, "INL", cfg, device="cpu")
    assert t.matches == -1
    res, t = tapi.finalize_join(tr, ts, res, t, "INL", cfg, device="cpu")
    assert res.overflow is None
    assert _pair(res) == want and t.matches == want[0]


@pytest.mark.parametrize("materialize", [False, True])
def test_nl_counts_duplicate_r_keys(materialize):
    """Every (R, S) pair counts; materialized, an S row's R payload is the
    sum of its partners' (mod 2^32), as the reference's."""
    rng = np.random.default_rng(5)
    rk = rng.integers(1, 300, 2000).astype(np.int32)
    sk = rng.integers(1, 400, 5000).astype(np.int32)
    rp, sp = (rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(
        np.int32) for n in (2000, 5000))
    (jr, js), (tr, ts) = _both(rk, rp, sk, sp)
    cfg = dict(materialize=materialize)
    tres, _ = tapi.run_join(tr, ts, "NL", TConfig(**cfg), device="cpu")
    jres, _ = japi.run_join(jr, js, "NL", JConfig(**cfg))
    assert _pair(tres) == _pair(jres)
    if materialize:
        assert _live(tres) == _live(jres)
        assert int(tres.matches) == int(np.isin(sk, rk).sum())
    else:
        gen = tmergejoin.merge_join_count_general(
            *(torch.from_numpy(a) for a in (rk, rp, sk, sp)))
        assert _pair(tres) == _pair(gen)
        assert int(tres.matches) > NS // 4


@pytest.mark.parametrize("form", ["checksummed", "keys-only",
                                  "materialize"])
@pytest.mark.parametrize("prof", [False, True])
def test_sortmerge_matches_reference_and_psm(form, prof):
    (jr, js), (tr, ts) = _both(*_arrays("nondense"))
    cfg = dict(FORMS[form], profile_phases=prof)
    tres, tt = tsortmerge._sortmerge(tr, ts, TConfig(**cfg))
    jres, _ = jsortmerge._sortmerge(jr, js, JConfig(**cfg))
    psm, _ = tapi.run_join(tr, ts, "PSM", TConfig(**cfg), device="cpu")
    assert _pair(tres) == _pair(jres) == _pair(psm)
    assert ("sort" in tt.phases) == prof and "merge" in tt.phases
    if form == "materialize":
        assert _live(tres) == _live(jres) == _live(psm)


@pytest.mark.parametrize("materialize", [False, True])
def test_nl_pads_never_match(materialize):
    """S keys -1 and R keys -2: the reference's tile pads (R -1, S -2)
    would partner them; the port pads nothing.  Held to the truth."""
    rng = np.random.default_rng(7)
    rk = np.concatenate([np.arange(1, 99), [-2, -2]]).astype(np.int32)
    sk = np.concatenate([rng.integers(1, 120, 300), [-1] * 5,
                         [-2] * 3]).astype(np.int32)
    rp = rng.integers(-1000, 1000, rk.size).astype(np.int32)
    sp = rng.integers(-1000, 1000, sk.size).astype(np.int32)
    _, (tr, ts) = _both(rk, rp, sk, sp)
    res, _ = tapi.run_join(tr, ts, "NL", TConfig(materialize=materialize),
                           device="cpu")
    m, ck, rows = _truth(rk, rp, sk, sp)
    if not materialize:
        assert _pair(res) == (m, ck)
        return
    # materialized: one row per matched S row, its R payloads summed
    hit = [(k, sum(rp[rk == k].tolist()), s) for k, s in
           zip(sk.tolist(), sp.tolist()) if (rk == k).any()]
    want = sorted((k, ((r + (1 << 31)) & U32) - (1 << 31), s)
                  for k, r, s in hit)
    assert _live(res) == want
    assert int(res.matches) == len(hit)


@pytest.mark.parametrize("name", CRACKING)
@pytest.mark.parametrize("materialize", [False, True])
def test_windowed_cracking_keeps_negative_keys(name, materialize):
    """Negative keys (and keys past R's 2^key_bits) fall outside every
    reference window; the port clamps their bucket and joins them."""
    rng = np.random.default_rng(9)
    # every key but -3, the holes' key
    rk = rng.permutation(np.r_[-500:-3, -2:500, 5000, 7000]).astype(np.int32)
    sk = np.concatenate([rng.choice(rk, 3000),
                         rng.integers(-900, 8000, 500)]).astype(np.int32)
    sk[sk == -3] = -4
    rp = rng.integers(-(1 << 31), 1 << 31, rk.size, dtype=np.int64)
    sp = rng.integers(-(1 << 31), 1 << 31, sk.size, dtype=np.int64)
    rp, sp = rp.astype(np.int32), sp.astype(np.int32)
    _, (tr, ts) = _both(rk, rp, sk, sp)
    cfg = TConfig(profile_phases=True, materialize=materialize,
                  partition_rows=32)
    res, tt = tapi.run_join(tr, ts, name, cfg, device="cpu")
    m, ck, rows = _truth_fast(rk, rp, sk, sp)
    assert _pair(res) == (m, ck) and m > 3000
    assert "partition" in tt.phases and "join" in tt.phases
    if materialize:
        assert _live(res) == rows


@pytest.mark.parametrize("name", ["CHT", "INL"])
@pytest.mark.parametrize("form", ["checksummed", "materialize"])
@pytest.mark.parametrize("prof", [False, True])
def test_empty_r_answers_zero(name, form, prof):
    """The reference raises on an empty R (CHT in both forms, INL's
    profile_phases form); the port answers 0."""
    rng = np.random.default_rng(3)
    sk = rng.integers(0, 100, 500).astype(np.int32)
    _, (tr, ts) = _both(np.zeros(0, np.int32), np.zeros(0, np.int32), sk,
                        sk)
    cfg = TConfig(**FORMS[form], profile_phases=prof)
    res, _ = tapi.run_join(tr, ts, name, cfg, device="cpu")
    assert _pair(res) == (0, 0)
    if form == "materialize":
        assert res.key.numel() == 512 and (res.key == -3).all()


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("form", list(FORMS))
def test_empty_s_answers_zero(name, form):
    rk, rp, _, _ = _arrays("fk")
    _, (tr, ts) = _both(rk, rp, np.zeros(0, np.int32), np.zeros(0, np.int32))
    for prof in (False, True):
        cfg = TConfig(**FORMS[form], profile_phases=prof,
                      partition_rows=PARTITION_ROWS)
        res, _ = tapi.run_join(tr, ts, name, cfg, device="cpu")
        assert _pair(res) == (0, 0)
        if form == "materialize":
            assert (res.key == -3).all()


def test_cuda_relations_are_refused_on_the_cpu_path():
    """run_join keeps its device check for the new names: CPU relations
    under device="cuda" raise when no card is present, never fall back."""
    _, (tr, ts) = _both(*_arrays("fk"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in NAMES:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapi.run_join(tr, ts, name)

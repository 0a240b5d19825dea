"""The port's RHO join as a whole against the JAX package's, on the CPU.

Both run_join("RHO") calls get the same relations, made with numpy and
handed to the port through Relation.from_numpy.  Results are integers and
must agree exactly; materialized columns are chunked differently by the two
packages, so their live (key, R payload, S payload) rows are compared as
multisets.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu import engine as jengine
from aqp_tpu.config import JoinConfig as JConfig
from aqp_tpu.data.generator import _zipf_cdf_lut
from aqp_tpu.joins.api import run_join as jrun
from aqp_tpu.relation import Relation as JRelation
from aqp_tpu_torch import engine as tengine
from aqp_tpu_torch.config import JoinConfig as TConfig
from aqp_tpu_torch.joins import radix as tradix
from aqp_tpu_torch.joins import skewtier as tskew
from aqp_tpu_torch.joins.api import finalize_join, run_join as trun
from aqp_tpu_torch.ops.kernels import rho3 as trho3
from aqp_tpu_torch.relation import JoinResult as TResult
from aqp_tpu_torch.relation import Relation as TRelation

NR, NS = 4096, 16384
NS_ZIPF = 1 << 18   # the skew hint needs a long run in a stride-128 sample
# 80 keys of 17,000 rows each: more heavy keys than the skew tier's 64
# candidates, and each too many for a fine slot even at the skew geometry
LADDER_KEYS, LADDER_COPIES = 80, 17_000


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
        if kind == "zipf":
            cdf = _zipf_cdf_lut(NR, 1.5).astype(np.float32)
            u = rng.random(NS_ZIPF, dtype=np.float32)
            sk = (rng.permutation(NR) + 1)[
                np.clip(np.searchsorted(cdf, u), 0, NR - 1)]
        if kind == "ladder":
            sk = np.repeat(rng.choice(NR, LADDER_KEYS, replace=False) + 1,
                           LADDER_COPIES)
            rng.shuffle(sk)
    rp = rng.integers(-(1 << 31), 1 << 31, NR, dtype=np.int64)
    sp = rng.integers(-(1 << 31), 1 << 31, sk.size, dtype=np.int64)
    return [a.astype(np.int32) for a in (rk, rp, sk, sp)]


def _relations(kind):
    rk, rp, sk, sp = _arrays(kind)
    j = (JRelation(jnp.asarray(rk), jnp.asarray(rp)),
         JRelation(jnp.asarray(sk), jnp.asarray(sp)))
    t = (TRelation.from_numpy(rk, rp, device="cpu"),
         TRelation.from_numpy(sk, sp, device="cpu"))
    return j, t


def _pair(res):
    return int(res.matches), int(res.checksum)


CASES = [
    # (data, config fields): dense path, rho3 path, non-dense R
    ("fk", {}),
    ("fk", {"checksum": False}),
    ("fk", {"dense_path": False}),
    ("fk", {"dense_path": False, "checksum": False}),
    ("nondense", {}),
    ("nondense", {"checksum": False}),
    ("fk", {"use_pallas": False, "dense_path": False}),
]


@pytest.mark.parametrize("kind,fields", CASES,
                         ids=[f"{k}-{'-'.join(f) or 'default'}"
                              for k, f in CASES])
def test_run_join_rho_matches_reference(kind, fields):
    (jr, js), (tr, ts) = _relations(kind)
    jres, _ = jrun(jr, js, "RHO", JConfig(**fields))
    tres, tt = trun(tr, ts, "RHO", TConfig(**fields), device="cpu")
    assert _pair(tres) == _pair(jres)
    assert tt.matches == int(jres.matches)
    assert tt.rows_in == NR + NS
    assert tres.overflow is None
    if kind == "fk":
        assert int(tres.matches) == NS


def test_run_join_defer_then_finalize():
    (jr, js), (tr, ts) = _relations("nondense")
    want = _pair(jrun(jr, js, "RHO", JConfig())[0])
    cfg = TConfig(defer=True, dense_path=False)
    res, t = trun(tr, ts, "RHO", cfg, device="cpu")
    assert t.matches == -1
    assert res.overflow is not None
    res, t = finalize_join(tr, ts, res, t, "RHO", cfg, device="cpu")
    assert res.overflow is None
    assert _pair(res) == want
    assert t.matches == want[0]


class _Spy:
    """Counts the calls of a module attribute, keyword arguments kept."""

    def __init__(self, monkeypatch, module, name):
        self.calls = []
        fn = getattr(module, name)

        def wrapped(*args, **kw):
            self.calls.append(kw)
            return fn(*args, **kw)

        monkeypatch.setattr(module, name, wrapped)


def test_overflow_walks_the_ladder_to_the_exact_core(monkeypatch):
    (jr, js), (tr, ts) = _relations("ladder")
    ns = LADDER_KEYS * LADDER_COPIES
    # every salt overflows, and so does the skew tier
    for salt in trho3.RETRY_SALTS:
        _, _, ovf = trho3.rho_join_count_v3(tr.key, tr.payload, ts.key,
                                            ts.payload, salt=salt)
        assert int(ovf) > 0
    _, _, ovf = tskew.skew_fused_count(tr.key, tr.payload, ts.key,
                                       ts.payload, trho3.RETRY_SALTS[0])
    assert int(ovf) > 0
    count = _Spy(monkeypatch, tradix.mergejoin, "merge_join_count")
    mat = _Spy(monkeypatch, tradix.mergejoin, "merge_join_materialize")
    jres = jrun(jr, js, "RHO", JConfig())[0]
    want = _pair(jres)
    got, _ = trun(tr, ts, "RHO", TConfig(dense_path=False), device="cpu")
    assert _pair(got) == want
    assert want[0] == ns
    assert len(count.calls) == 1
    # a deferred call reports the overflow; finalize takes the ladder
    cfg = TConfig(defer=True, dense_path=False)
    res, t = trun(tr, ts, "RHO", cfg, device="cpu")
    assert int(res.overflow) > 0
    res, _ = finalize_join(tr, ts, res, t, "RHO", cfg, device="cpu")
    assert _pair(res) == want
    assert len(count.calls) == 2
    # the materializing ladder ends at the exact core too
    jm = jrun(jr, js, "RHO", JConfig(materialize=True))[0]
    tm, _ = trun(tr, ts, "RHO", TConfig(materialize=True, dense_path=False),
                 device="cpu")
    assert len(mat.calls) == 1
    assert _pair(tm) == _pair(jm) == want
    assert _live(tm) == _live(jm)
    assert tm.key.numel() == -(-ns // 128) * 128


def _live(res):
    k, a, b = (np.asarray(x) for x in (res.key, res.r_payload,
                                       res.s_payload))
    m = k != -3
    return sorted(zip(k[m].tolist(), a[m].tolist(), b[m].tolist()))


MAT_CASES = [
    ("fk", {}),                       # the dense path, in place
    ("fk", {"dense_path": False}),    # rho_join_materialize_v3
    ("nondense", {}),
    ("zipf", {"dense_path": False}),  # the hinted skew-split materializer
    ("fk", {"use_pallas": False, "dense_path": False}),   # the exact core
]


@pytest.mark.parametrize("kind,fields", MAT_CASES,
                         ids=[f"{k}-{'-'.join(f) or 'default'}"
                              for k, f in MAT_CASES])
def test_run_join_rho_materialize_matches_reference(kind, fields,
                                                    monkeypatch):
    spy = _Spy(monkeypatch, tradix, "rho_skew_split_materialize")
    (jr, js), (tr, ts) = _relations(kind)
    cfg = dict(fields, materialize=True)
    jres, _ = jrun(jr, js, "RHO", JConfig(**cfg))
    tres, tt = trun(tr, ts, "RHO", TConfig(**cfg), device="cpu")
    assert _pair(tres) == _pair(jres)
    assert tres.materialized and tres.overflow is None
    assert tt.matches == int(jres.matches)
    assert _live(tres) == _live(jres)
    assert int((tres.key != -3).sum()) == int(tres.matches)
    assert len(spy.calls) == (1 if kind == "zipf" else 0)


@pytest.mark.parametrize("checksum", [True, False], ids=["sum", "keys"])
def test_hinted_count_ladder_on_zipf_keys(checksum, monkeypatch):
    spy = _Spy(monkeypatch, tradix, "skew_fused_count")
    (jr, js), (tr, ts) = _relations("zipf")
    hinted, cap = tskew.skew_plan(ts.key)
    assert hinted and cap > 0
    jres, _ = jrun(jr, js, "RHO", JConfig(checksum=checksum))
    tres, _ = trun(tr, ts, "RHO", TConfig(checksum=checksum,
                                          dense_path=False), device="cpu")
    if checksum:
        assert _pair(tres) == _pair(jres)
    else:
        assert int(tres.matches) == int(jres.matches)
        assert int(tres.checksum) == 0
    assert int(tres.matches) == NS_ZIPF
    # the compacted-residual tier served, and its plan was not demoted
    assert [c.get("resid_cap_rows", 0) for c in spy.calls] == [cap]
    assert tskew.skew_plan(ts.key) == (True, cap)


def test_deferred_materialize_keeps_its_columns():
    (jr, js), (tr, ts) = _relations("nondense")
    want = jrun(jr, js, "RHO", JConfig(materialize=True))[0]
    cfg = TConfig(defer=True, materialize=True, dense_path=False)
    res, t = trun(tr, ts, "RHO", cfg, device="cpu")
    assert t.matches == -1 and res.overflow is not None
    key = res.key
    res, t = finalize_join(tr, ts, res, t, "RHO", cfg, device="cpu")
    assert res.overflow is None and res.key is key
    assert _pair(res) == _pair(want)
    assert _live(res) == _live(want)
    assert t.matches == int(want.matches)


def test_finalize_after_overflow_demotes_the_residual_plan():
    (jr, js), (tr, ts) = _relations("zipf")
    hinted, cap = tskew.skew_plan(ts.key)
    assert hinted and cap > 0
    bad = TResult(matches=torch.zeros((), dtype=torch.int64),
                  checksum=torch.zeros((), dtype=torch.int64),
                  overflow=torch.ones((), dtype=torch.int64))
    res, _ = finalize_join(tr, ts, bad, tradix.PhaseTimer("cpu").t, "RHO",
                           TConfig(dense_path=False), device="cpu")
    assert tskew.skew_plan(ts.key) == (True, 0)
    assert _pair(res) == _pair(jrun(jr, js, "RHO", JConfig())[0])


def test_engine_materialize_entry_points_match_reference():
    rk, rp, sk, sp = _arrays("nondense")
    jargs = [jnp.asarray(a) for a in (rk, rp, sk, sp)]
    targs = [torch.from_numpy(a) for a in (rk, rp, sk, sp)]
    j = jengine.rho_join_materialize_fused(*jargs)
    t = tengine.rho_join_materialize_fused(*targs, device="cpu")
    assert int(t[5]) == 0
    assert (int(t[0]), int(t[1])) == (int(j[0]), int(j[1]))
    assert _live(TResult(*t[:5])) == _live(TResult(*j[:5]))
    cap = NS + 128
    j2 = jengine.rho_join_materialize(*jargs, capacity=cap)
    t2 = tengine.rho_join_materialize(*targs, cap, device="cpu")
    assert t2.key.shape == (cap,)
    assert (int(t2.matches), int(t2.checksum)) == (int(j2.matches),
                                                   int(j2.checksum))
    assert _live(TResult(*t2)) == _live(TResult(*j2))
    # live rows first, holes behind
    m = int(t2.matches)
    assert (t2.key[:m] != -3).all() and (t2.key[m:] == -3).all()


def test_engine_entry_points_match_reference():
    rk, rp, sk, sp = _arrays("nondense")
    jargs = [jnp.asarray(a) for a in (rk, rp, sk, sp)]
    targs = [torch.from_numpy(a) for a in (rk, rp, sk, sp)]
    jm, jc, _ = jengine.rho_join_count_fused(*jargs)
    tm, tc, tovf = tengine.rho_join_count_fused(*targs, device="cpu")
    assert int(tovf) == 0
    assert (int(tm), int(tc)) == (int(jm), int(jc))
    jm2, jc2 = jengine.rho_join_count_checked(*jargs)
    tm2, tc2 = tengine.rho_join_count_checked(*targs, device="cpu")
    assert (int(tm2), int(tc2)) == (int(jm2), int(jc2))
    j3 = jengine.rho_join_count(*jargs)
    t3 = tengine.rho_join_count(*targs, device="cpu")
    assert (int(t3.matches), int(t3.checksum)) == (int(j3.matches),
                                                   int(j3.checksum))


def test_unknown_algorithm_names_the_registered_ones():
    _, (tr, ts) = _relations("fk")
    with pytest.raises(ValueError, match="RHO"):
        trun(tr, ts, "NOPE", device="cpu")


def test_relations_on_another_device_raise():
    _, (tr, ts) = _relations("fk")
    meta = TRelation(tr.key.to("meta"), tr.payload.to("meta"))
    with pytest.raises(ValueError, match="not on cpu"):
        trun(meta, ts, "RHO", device="cpu")


def test_cpu_run_launches_no_kernel():
    _, (tr, ts) = _relations("fk")
    before = dict(trho3.LAUNCHES)
    trun(tr, ts, "RHO", TConfig(dense_path=False), device="cpu")
    assert trho3.LAUNCHES == before


def test_dense_proof_is_cached_per_tensor(monkeypatch):
    from aqp_tpu_torch.joins import dense

    calls = []
    check = dense._dense_check
    monkeypatch.setattr(dense, "_dense_check",
                        lambda t: calls.append(1) or check(t))
    key = torch.randperm(1000, dtype=torch.int32) + 1
    assert dense.dense_proof(key) and dense.dense_proof(key)
    assert len(calls) == 1
    assert dense.dense_proof(key.clone()) and len(calls) == 2
    key[0] = 5000                   # an in-place write: proved anew
    assert not dense.dense_proof(key) and len(calls) == 3
    assert not dense.dense_proof(key) and len(calls) == 3


PAD_KEYS = ((1 << 30) - 2, (1 << 30) - 1)    # the pipeline's input pads


@pytest.mark.parametrize("fields", [{"checksum": False}, {},
                                    {"materialize": True}],
                         ids=["keys", "sum", "materialize"])
def test_input_pad_keys_go_to_the_exact_core(fields, monkeypatch):
    """R holds 2^30-2 among ordinary keys, S holds 2^30-2 and 2^30-1: the
    pipeline would drop both as input pads with overflow 0, so RHO sends
    the call to the exact core, and the answer is the reference's."""
    rng = np.random.default_rng(21)
    rk = np.append(rng.choice(1 << 28, 4095, replace=False) + 1,
                   PAD_KEYS[0])
    sk = np.concatenate([rng.choice(rk[:-1], 5000), PAD_KEYS])
    rng.shuffle(sk)
    rp = rng.integers(-(1 << 31), 1 << 31, rk.size, dtype=np.int64)
    sp = rng.integers(-(1 << 31), 1 << 31, sk.size, dtype=np.int64)
    rk, rp, sk, sp = (a.astype(np.int32) for a in (rk, rp, sk, sp))
    exact = _Spy(monkeypatch, tradix.mergejoin,
                 "merge_join_materialize" if fields.get("materialize")
                 else "merge_join_count" if fields.get("checksum", True)
                 else "merge_join_count_keys")
    jres, _ = jrun(JRelation(jnp.asarray(rk), jnp.asarray(rp)),
                   JRelation(jnp.asarray(sk), jnp.asarray(sp)), "RHO",
                   JConfig(**fields))
    tres, _ = trun(TRelation.from_numpy(rk, rp, device="cpu"),
                   TRelation.from_numpy(sk, sp, device="cpu"), "RHO",
                   TConfig(**fields), device="cpu")
    assert int(jres.matches) == 5001
    assert _pair(tres) == _pair(jres)
    assert tres.overflow is None
    assert len(exact.calls) == 1
    if fields.get("materialize"):
        assert _live(tres) == _live(jres)


@pytest.mark.parametrize("fields", [{"checksum": False}, {},
                                    {"materialize": True}],
                         ids=["keys", "sum", "materialize"])
def test_empty_build_side_gives_zero_results(fields):
    """|R| = 0 on the dense path (its proof holds vacuously): no match, a
    zero checksum and materialized columns of holes only.  (The reference
    raises a TypeError there.)"""
    r = TRelation.from_numpy(np.zeros(0, np.int32), device="cpu")
    sk = np.arange(1, 1001, dtype=np.int32)
    s = TRelation.from_numpy(sk, sk * 3, device="cpu")
    for dense in (True, False):
        res, _ = trun(r, s, "RHO", TConfig(dense_path=dense, **fields),
                      device="cpu")
        assert _pair(res) == (0, 0)
        if fields.get("materialize"):
            assert _live(res) == []
            assert not res.r_payload.any() and not res.s_payload.any()


EMPTY_PROBE_FIELDS = [{}, {"checksum": False}, {"materialize": True},
                      {"profile_phases": True}]


@pytest.mark.parametrize("fields", EMPTY_PROBE_FIELDS,
                         ids=["sum", "keys", "materialize", "profile"])
def test_empty_probe_side_matches_reference(fields):
    """|S| = 0 (the skew plan's sample is empty): matches and checksum 0,
    as the reference answers; materialized columns hold holes only."""
    rk = np.arange(5000, dtype=np.int32)
    sk = np.zeros(0, np.int32)
    jres, _ = jrun(JRelation(jnp.asarray(rk), jnp.asarray(rk * 3)),
                   JRelation(jnp.asarray(sk), jnp.asarray(sk)), "RHO",
                   JConfig(**fields))
    tres, tt = trun(TRelation.from_numpy(rk, rk * 3, device="cpu"),
                    TRelation.from_numpy(sk, sk, device="cpu"), "RHO",
                    TConfig(**fields), device="cpu")
    assert _pair(tres) == _pair(jres) == (0, 0)
    assert tt.matches == 0 and tres.overflow is None
    if fields.get("materialize"):
        assert _live(tres) == _live(jres) == []

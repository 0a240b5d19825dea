"""The port's radix and sort-merge engines (RHO_seq, RHT, RSM, MWAY, PSM,
and RHO with use_pallas=False) against the JAX package's, through run_join
on the CPU.

Both get the same relations, made with numpy.  On the CPU both packages
run the radix frame (fused on rotated keys, or staged under
profile_phases), PSM's sorts and MWAY's explicit run sort and merge tree.
Matches and checksums must agree exactly, materialized output as
multisets of live (key, R payload, S payload) rows.  MWAY's range route
runs on a CUDA device only; here its pipeline call is held against the
reference's in interpret mode at a small geometry, and the route itself
is forced onto the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.config import JoinConfig as JConfig
from aqp_tpu.joins.api import run_join as jrun
from aqp_tpu.ops.pallas import rho3 as jrho3
from aqp_tpu.relation import Relation as JRelation
from aqp_tpu_torch.config import JoinConfig as TConfig
from aqp_tpu_torch.joins import radix as tradix
from aqp_tpu_torch.joins import sortmerge as tsm
from aqp_tpu_torch.joins.api import run_join as trun
from aqp_tpu_torch.ops import mergejoin as tmj
from aqp_tpu_torch.ops.kernels import rho3 as trho3
from aqp_tpu_torch.relation import Relation as TRelation

NR, NS = 4096, 16384
NAMES = ["RHO_seq", "RHT", "RSM", "MWAY", "PSM", "RHO"]


def _arrays(kind, seed=17):
    rng = np.random.default_rng(seed)
    if kind == "dupr":      # R keys repeat (up to a handful of copies)
        rk = rng.integers(1, 1500, NR)
        sk = np.where(rng.random(NS) < 0.7, rng.choice(rk, NS),
                      rng.integers(1, 3000, NS))
    else:                   # unique R over [1, 2^28), 60% of S hits R
        rk = rng.choice(1 << 28, NR, replace=False) + 1
        sk = np.where(rng.random(NS) < 0.6, rng.choice(rk, NS),
                      rng.integers(1, 1 << 28, NS))
    rp = rng.integers(-(1 << 31), 1 << 31, NR, dtype=np.int64)
    sp = rng.integers(-(1 << 31), 1 << 31, NS, dtype=np.int64)
    return [a.astype(np.int32) for a in (rk, rp, sk, sp)]


def _relations(arrays):
    rk, rp, sk, sp = arrays
    return ((JRelation(jnp.asarray(rk), jnp.asarray(rp)),
             JRelation(jnp.asarray(sk), jnp.asarray(sp))),
            (TRelation.from_numpy(rk, rp, device="cpu"),
             TRelation.from_numpy(sk, sp, device="cpu")))


def _pair(res):
    return int(res.matches), int(res.checksum)


def _live(res):
    k, a, b = (np.asarray(x) for x in (res.key, res.r_payload,
                                       res.s_payload))
    m = k != -3
    return sorted(zip(k[m].tolist(), a[m].tolist(), b[m].tolist()))


CONFIGS = {
    "keys": {"checksum": False},
    "sum": {},
    "materialize": {"materialize": True},
    "profile-sum": {"profile_phases": True},
    "profile-materialize": {"profile_phases": True, "materialize": True},
    "bits13-sum": {"radix_bits": 13},
    "bits13-profile": {"radix_bits": 13, "profile_phases": True},
}


@pytest.fixture(scope="module")
def nondense():
    return _relations(_arrays("nondense"))


def _configs(name, fields):
    fields = dict(fields)
    if name == "RHO":   # the radix frame, not the ladder
        fields.update(use_pallas=False)
    return JConfig(**fields), TConfig(**fields)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("name", NAMES)
def test_engine_matches_reference(name, cfg, nondense):
    (jr, js), (tr, ts) = nondense
    jcfg, tcfg = _configs(name, CONFIGS[cfg])
    jres, jt = jrun(jr, js, name, jcfg)
    tres, tt = trun(tr, ts, name, tcfg, device="cpu")
    assert _pair(tres) == _pair(jres)
    assert tt.matches == int(jres.matches) > 0
    assert tt.rows_in == NR + NS
    assert sorted(tt.phases) == sorted(jt.phases)
    if tcfg.materialize:
        assert tres.materialized
        assert _live(tres) == _live(jres)
        assert len(_live(tres)) == int(tres.matches)


@pytest.mark.parametrize("profile", [False, True], ids=["fused", "staged"])
@pytest.mark.parametrize("checksum", [True, False], ids=["sum", "keys"])
def test_rht_counts_every_duplicate_r_row(checksum, profile):
    (jr, js), (tr, ts) = _relations(_arrays("dupr"))
    fields = dict(checksum=checksum, profile_phases=profile)
    jres, _ = jrun(jr, js, "RHT", JConfig(**fields))
    tres, _ = trun(tr, ts, "RHT", TConfig(**fields), device="cpu")
    assert _pair(tres) == _pair(jres)
    gen = tmj.merge_join_count_general(tr.key, tr.payload, ts.key,
                                       ts.payload)
    assert int(tres.matches) == int(gen.matches) > NS // 2
    if checksum or profile:     # the staged probe always sums
        assert int(tres.checksum) == int(gen.checksum)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("cfg", ["sum", "materialize", "profile-sum"])
def test_empty_build_side(name, cfg):
    r = TRelation.from_numpy(np.zeros(0, np.int32), device="cpu")
    sk = np.arange(1, 1001, dtype=np.int32)
    s = TRelation.from_numpy(sk, sk * 3, device="cpu")
    _, tcfg = _configs(name, CONFIGS[cfg])
    res, t = trun(r, s, name, tcfg, device="cpu")
    assert _pair(res) == (0, 0) and t.matches == 0
    if tcfg.materialize:
        assert _live(res) == []


@pytest.mark.parametrize("name", ["RHO_seq", "RHT", "RSM", "RHO"])
def test_keys_at_or_above_2_30_do_not_alias(name):
    """Rotation is a bijection on [0, 2^30) only: rot(1) == rot(2^30) at
    one radix bit.  Such keys send the call to the staged form, whose
    answer is the exact core's."""
    rk = np.arange(1, 101, dtype=np.int32)
    sk = np.array([1 << 30, (1 << 30) + 2, 5, 7], dtype=np.int32)
    r = TRelation.from_numpy(rk, rk, device="cpu")
    s = TRelation.from_numpy(sk, sk, device="cpu")
    assert torch.equal(tradix._rot(torch.tensor([1]), 1),
                       tradix._rot(torch.tensor([1 << 30]), 1))
    _, tcfg = _configs(name, {"radix_bits": 1})
    res, _ = trun(r, s, name, tcfg, device="cpu")
    exact = tmj.merge_join_count(r.key, r.payload, s.key, s.payload)
    assert _pair(res) == (2, int(exact.checksum))


# MWAY's range route: the pipeline at salt 1 with the observed-domain
# scale.  A small geometry keeps the reference's interpret mode quick.
SMALL = dict(block_rows=64, slot_rows=8, f1=16, f2=4, kd_slot_rows=16)


def test_mway_scale_matches_reference_float32():
    rk, _, sk, _ = _arrays("nondense")
    for prm in (trho3.Rho3Params(), trho3.Rho3Params(**SMALL)):
        kmax = jnp.maximum(jnp.max(rk), jnp.max(sk)).astype(jnp.float32)
        want = jnp.float32(prm.gmax) / (kmax + 1.0) * (1.0 - 1e-6)
        got = tsm.mway_scale(torch.from_numpy(rk), torch.from_numpy(sk),
                             prm)
        assert np.float32(got) == np.asarray(want)


@pytest.mark.parametrize("with_checksum", [True, False],
                         ids=["sum", "keys"])
def test_mway_range_pipeline_matches_reference(with_checksum):
    data = _arrays("nondense")
    rk, _, sk, _ = data
    tprm = trho3.Rho3Params(**SMALL)
    scale = tsm.mway_scale(torch.from_numpy(rk), torch.from_numpy(sk), tprm)
    jm, jc, jovf = jrho3.rho_join_count_v3(
        *map(jnp.asarray, data), prm=jrho3.Rho3Params(**SMALL), salt=1,
        interpret=True, with_checksum=with_checksum,
        scale=jnp.float32(scale))
    tm, tc, tovf = trho3.rho_join_count_v3(
        *map(torch.from_numpy, data), prm=tprm, salt=1,
        with_checksum=with_checksum, scale=scale)
    assert int(jovf) == int(tovf) == 0
    assert (int(tm), int(tc)) == (int(jm), int(jc))
    exact = tmj.merge_join_count(*map(torch.from_numpy, data))
    assert int(tm) == int(exact.matches)


class _Spy:
    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def wrapped(*args, **kw):
            self.calls += 1
            return fn(*args, **kw)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("cfg", ["keys", "sum", "materialize"])
def test_mway_range_route_forced_on_the_cpu(cfg, monkeypatch, nondense):
    """The route a CUDA device takes, through the plain versions: the same
    answer as the reference's MWAY."""
    monkeypatch.setattr(tsm, "_mway_range_available", lambda *a: True)
    spy = _Spy(monkeypatch, tsm, "rho_join_materialize_v3"
               if cfg == "materialize" else "rho_join_count_v3")
    (jr, js), (tr, ts) = nondense
    fields = CONFIGS[cfg]
    jres, _ = jrun(jr, js, "MWAY", JConfig(**fields))
    tres, _ = trun(tr, ts, "MWAY", TConfig(**fields), device="cpu")
    assert spy.calls == 1
    assert int(tres.matches) == int(jres.matches)
    if cfg != "keys":   # the reference's explicit form always sums
        assert int(tres.checksum) == int(jres.checksum)
    else:
        assert int(tres.checksum) == 0
    if cfg == "materialize":
        assert _live(tres) == _live(jres)


@pytest.mark.parametrize("cfg", ["keys", "sum", "materialize"])
def test_mway_range_overflow_falls_back_to_the_exact_core(cfg,
                                                          monkeypatch):
    """One key on every S row overflows a range bucket; the call answers
    from the exact core."""
    monkeypatch.setattr(tsm, "_mway_range_available", lambda *a: True)
    exact_name = {"keys": "merge_join_count_keys", "sum": "merge_join_count",
                  "materialize": "merge_join_materialize"}[cfg]
    spy = _Spy(monkeypatch, tsm.mergejoin, exact_name)
    rk, rp, _, _ = _arrays("nondense")
    sk = np.full(NS, rk[7], np.int32)
    sp = np.arange(NS, dtype=np.int32)
    (jr, js), (tr, ts) = _relations([rk, rp, sk, sp])
    fields = CONFIGS[cfg]
    count = tsm._mway_range_count(tr.key, tr.payload, ts.key, ts.payload,
                                  True)
    assert int(count[2]) > 0
    jres, _ = jrun(jr, js, "MWAY", JConfig(**fields))
    tres, _ = trun(tr, ts, "MWAY", TConfig(**fields), device="cpu")
    assert spy.calls == 1
    assert int(tres.matches) == int(jres.matches) == NS
    if cfg != "keys":
        assert int(tres.checksum) == int(jres.checksum)
    if cfg == "materialize":
        assert _live(tres) == _live(jres)

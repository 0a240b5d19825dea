"""The port's no-partition joins (PHT, PHT_no, PHT_un, PHT_o, NPO_st, NPO_no,
NPBC_st) against the JAX package's, through run_join on the CPU.

Both get the same relations, made with numpy.  On the CPU the reference
runs its staged open-addressing engine (and NPBC_st its bucket-major
form); the port runs its nphj pipeline through the plain versions, or its
own staged engine under use_pallas=False / profile_phases.  Matches and
checksums must agree exactly, materialized output as multisets of live
(key, R payload, S payload) rows.  Keys-only calls compare matches (the
reference's open-addressing engine sums payloads anyway; the port's
keys-only pipeline returns 0)."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.config import JoinConfig as JConfig
from aqp_tpu.data.generator import _zipf_cdf_lut
from aqp_tpu.joins.api import run_join as jrun
from aqp_tpu.relation import Relation as JRelation
from aqp_tpu_torch.config import JoinConfig as TConfig
from aqp_tpu_torch.joins import nopart as tnp
from aqp_tpu_torch.joins import radix as tradix
from aqp_tpu_torch.joins import skewtier as tskew
from aqp_tpu_torch.joins.api import finalize_join, run_join as trun
from aqp_tpu_torch.ops.kernels import nphj as tnphj
from aqp_tpu_torch.ops.kernels import rho3 as trho3
from aqp_tpu_torch.ops.kernels import rstats as trstats
from aqp_tpu_torch.relation import Relation as TRelation

NAMES = ["PHT", "PHT_no", "PHT_un", "PHT_o", "NPO_st", "NPO_no", "NPBC_st"]
PIPELINED = NAMES[:-1]
NR, NS = 4096, 16384
NS_ZIPF = 1 << 18   # the skew hint needs a long run in a stride-128 sample
PAD_KEYS = [(1 << 30) - 2, (1 << 30) - 1]


def _arrays(kind, seed=13):
    rng = np.random.default_rng(seed)
    rk = rng.permutation(NR) + 1
    if kind == "fk":
        sk = np.concatenate([rng.permutation(NR) + 1
                             for _ in range(NS // NR)])
    elif kind == "nondense":
        rk = rng.choice(1 << 28, NR, replace=False) + 1
        sk = np.where(rng.random(NS) < 0.6, rng.choice(rk, NS),
                      rng.integers(1, 1 << 28, NS))
    elif kind == "zipf":
        cdf = _zipf_cdf_lut(NR, 1.5).astype(np.float32)
        u = rng.random(NS_ZIPF, dtype=np.float32)
        sk = (rng.permutation(NR) + 1)[np.clip(np.searchsorted(cdf, u), 0,
                                               NR - 1)]
    elif kind == "pads":
        # C2's keys: R holds 2^30-2, S both input-pad values
        rk = np.append(rng.choice(1 << 28, NR - 1, replace=False) + 1,
                       PAD_KEYS[0])
        sk = np.concatenate([rng.choice(rk[:-1], NS - 2), PAD_KEYS])
        rng.shuffle(sk)
    elif kind == "dupR":
        rk = rng.integers(1, NR // 2, NR)
        sk = rng.integers(1, NR, NS)
    rp = rng.integers(-(1 << 31), 1 << 31, rk.size, dtype=np.int64)
    sp = rng.integers(-(1 << 31), 1 << 31, sk.size, dtype=np.int64)
    return [a.astype(np.int32) for a in (rk, rp, sk, sp)]


@functools.lru_cache(maxsize=None)
def _reference(kind, name, checksum=True, materialize=False):
    rk, rp, sk, sp = _arrays(kind)
    res, _ = jrun(JRelation(jnp.asarray(rk), jnp.asarray(rp)),
                  JRelation(jnp.asarray(sk), jnp.asarray(sp)), name,
                  JConfig(checksum=checksum, materialize=materialize))
    out = [int(res.matches), int(res.checksum)]
    if materialize:
        out.append(_live(res))
    return tuple(out)


def _port(kind, name, **fields):
    rk, rp, sk, sp = _arrays(kind)
    r = TRelation.from_numpy(rk, rp, device="cpu")
    s = TRelation.from_numpy(sk, sp, device="cpu")
    res, t = trun(r, s, name, TConfig(**fields), device="cpu")
    assert res.overflow is None
    assert t.rows_in == rk.size + sk.size and t.matches == int(res.matches)
    return res


def _pair(res):
    return int(res.matches), int(res.checksum)


def _live(res):
    k, a, b = (np.asarray(x) for x in (res.key, res.r_payload,
                                       res.s_payload))
    m = k != -3
    return sorted(zip(k[m].tolist(), a[m].tolist(), b[m].tolist()))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["fk", "nondense", "zipf", "pads"])
def test_count_matches_reference(kind, name):
    res = _port(kind, name)
    assert _pair(res) == _reference(kind, name)
    if kind in ("fk", "zipf"):
        assert int(res.matches) == _arrays(kind)[2].size


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["fk", "zipf", "pads"])
def test_keys_only_matches_reference(kind, name):
    res = _port(kind, name, checksum=False)
    assert int(res.matches) == _reference(kind, name, checksum=False)[0]
    assert int(res.checksum) == 0


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("kind", ["nondense", "pads"])
def test_materialize_matches_reference(kind, name):
    res = _port(kind, name, materialize=True)
    m, c, live = _reference(kind, name, materialize=True)
    assert _pair(res) == (m, c)
    assert res.materialized and _live(res) == live
    assert int((res.key == -3).sum()) == res.key.numel() - m
    if name in PIPELINED and kind == "nondense":
        # the nphj materializer's region-chunked length
        prm = tnphj.VARIANT_PARAMS[name]
        nbg_r = trho3.num_blocks(NR, prm) // prm.group
        nbg_s = trho3.num_blocks(NS, prm) // prm.group
        assert res.key.numel() == prm.f1 * prm.f2 * tnphj.mat_chunk(
            nbg_r, nbg_s, prm.cap2)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("fields", [{"use_pallas": False},
                                    {"profile_phases": True},
                                    {"use_pallas": False,
                                     "materialize": True}],
                         ids=["staged", "profile", "staged-materialize"])
def test_staged_engines_match_reference(fields, name, monkeypatch):
    calls = []
    monkeypatch.setattr(tnp, "nphj_join_count",
                        lambda *a, **k: calls.append(1))
    res = _port("nondense", name, **fields)
    if fields.get("materialize"):
        m, c, live = _reference("nondense", name, materialize=True)
        assert _live(res) == live
    else:
        m, c = _reference("nondense", name)
    assert _pair(res) == (m, c)
    assert not calls


@pytest.mark.parametrize("name", NAMES)
def test_duplicate_r_keys_match_reference_counts(name):
    res = _port("dupR", name)
    m, c = _reference("dupR", name)
    assert int(res.matches) == m
    if name == "NPBC_st":   # bucket chaining counts every (R, S) pair
        assert int(res.checksum) == c


@pytest.mark.parametrize("name", ["PHT", "NPO_no"])
@pytest.mark.parametrize("materialize", [False, True],
                         ids=["count", "materialize"])
def test_defer_then_finalize(name, materialize):
    rk, rp, sk, sp = _arrays("nondense")
    r = TRelation.from_numpy(rk, rp, device="cpu")
    s = TRelation.from_numpy(sk, sp, device="cpu")
    cfg = TConfig(defer=True, materialize=materialize)
    res, t = trun(r, s, name, cfg, device="cpu")
    assert t.matches == -1 and res.overflow is not None
    res, t = finalize_join(r, s, res, t, name, cfg, device="cpu")
    assert res.overflow is None
    want = _reference("nondense", name, materialize=materialize)
    assert _pair(res) == want[:2] and t.matches == want[0]
    if materialize:
        assert _live(res) == want[2]


def test_zipf_takes_the_skew_tier_with_the_variant_pipeline(monkeypatch):
    seen = []
    fused = tskew.skew_fused_count

    def spy(*args, **kw):
        seen.append(kw.get("pipeline"))
        return fused(*args, **kw)

    monkeypatch.setattr(tradix, "skew_fused_count", spy)
    res = _port("zipf", "PHT_un")
    assert _pair(res) == _reference("zipf", "PHT_un")
    assert seen and seen[0] is tnphj.VARIANT_PIPELINES_SKEW["PHT_un"]


def test_cpu_run_launches_no_kernel():
    before = [dict(c) for c in (trho3.LAUNCHES, tnphj.LAUNCHES,
                                trstats.LAUNCHES)]
    _port("zipf", "PHT")
    _port("fk", "PHT_o", materialize=True)
    assert before == [dict(c) for c in (trho3.LAUNCHES, tnphj.LAUNCHES,
                                        trstats.LAUNCHES)]


@pytest.mark.parametrize("name", PIPELINED)
@pytest.mark.parametrize("checksum", [True, False], ids=["sum", "keys"])
def test_empty_probe_side_matches_reference(checksum, name):
    """|S| = 0: matches and checksum 0, as the reference answers."""
    rk = np.arange(5000, dtype=np.int32)
    sk = np.zeros(0, np.int32)
    jres, _ = jrun(JRelation(jnp.asarray(rk), jnp.asarray(rk * 3)),
                   JRelation(jnp.asarray(sk), jnp.asarray(sk)), name,
                   JConfig(checksum=checksum))
    tres, tt = trun(TRelation.from_numpy(rk, rk * 3, device="cpu"),
                    TRelation.from_numpy(sk, sk, device="cpu"), name,
                    TConfig(checksum=checksum), device="cpu")
    assert int(tres.matches) == int(jres.matches) == 0
    assert int(tres.checksum) == int(jres.checksum) == 0
    assert tt.matches == 0 and tres.overflow is None

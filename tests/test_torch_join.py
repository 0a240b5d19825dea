"""The port's RHO count path as a whole against the JAX package's, on the CPU.

Both run_join("RHO") calls get the same relations, made with numpy and
handed to the port through Relation.from_numpy.  Results are integers and
must agree exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu import engine as jengine
from aqp_tpu.config import JoinConfig as JConfig
from aqp_tpu.joins.api import run_join as jrun
from aqp_tpu.relation import Relation as JRelation
from aqp_tpu_torch import engine as tengine
from aqp_tpu_torch.config import JoinConfig as TConfig
from aqp_tpu_torch.joins.api import finalize_join, run_join as trun
from aqp_tpu_torch.ops.kernels import rho3 as trho3
from aqp_tpu_torch.relation import Relation as TRelation

NR, NS = 4096, 16384


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
        if kind == "skew":   # one key on every S row: every slot overflows
            sk = np.full(NS, 77)
    rp = rng.integers(-(1 << 31), 1 << 31, NR, dtype=np.int64)
    sp = rng.integers(-(1 << 31), 1 << 31, NS, dtype=np.int64)
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


def test_overflow_walks_the_ladder_to_the_exact_core():
    (jr, js), (tr, ts) = _relations("skew")
    # every salt overflows on one repeated key
    for salt in trho3.RETRY_SALTS:
        _, _, ovf = trho3.rho_join_count_v3(tr.key, tr.payload, ts.key,
                                            ts.payload, salt=salt)
        assert int(ovf) > 0
    want = _pair(jrun(jr, js, "RHO", JConfig())[0])
    got, _ = trun(tr, ts, "RHO", TConfig(dense_path=False), device="cpu")
    assert _pair(got) == want
    assert want[0] == NS
    # a deferred call reports the overflow; finalize takes the ladder
    cfg = TConfig(defer=True, dense_path=False)
    res, t = trun(tr, ts, "RHO", cfg, device="cpu")
    assert int(res.overflow) > 0
    res, _ = finalize_join(tr, ts, res, t, "RHO", cfg, device="cpu")
    assert _pair(res) == want


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
        trun(tr, ts, "PHT", device="cpu")


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

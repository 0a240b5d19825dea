"""The port's cracking stores (`CrackedRelation`, crack_relation, crack_to,
crk_join_cracked) against the JAX package's, on the CPU.

tests/test_crack.py's four cases on the port: the tree's spans, lazy reuse
across queries (the same objects back, no crack sort), incremental
refinement and the windowed materialize multiset.  Both packages crack the
same seeded numpy relation (1,024 dense keys, 4,096 foreign keys): the
spans and the cracked key and payload order must be the reference's at
the same depth.  The file takes about 8 s on one worker of this
repository's CPU test run.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from aqp_tpu.config import JoinConfig as JConfig
from aqp_tpu.joins import crk as jcrk
from aqp_tpu.relation import Relation as JRelation
from aqp_tpu_torch.config import JoinConfig as TConfig
from aqp_tpu_torch.joins import crk as tcrk
from aqp_tpu_torch.ops import mergejoin as tmergejoin
from aqp_tpu_torch.relation import Relation as TRelation
from aqp_tpu_torch.utils.timing import PhaseTimer

NR, NS = 1 << 10, 1 << 12
KB = 11                      # ceil(log2(1,024)) + 1, as _crk takes it


def _workload(seed=201):
    rng = np.random.default_rng(seed)
    rk = (rng.permutation(NR) + 1).astype(np.int32)
    sk = rng.integers(1, NR + 1, NS).astype(np.int32)
    rp, sp = (rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(
        np.int32) for n in (NR, NS))
    j = (JRelation(jnp.asarray(rk), jnp.asarray(rp)),
         JRelation(jnp.asarray(sk), jnp.asarray(sp)))
    t = (TRelation.from_numpy(rk, rp, device="cpu"),
         TRelation.from_numpy(sk, sp, device="cpu"))
    return j, t


def _same_store(t, j):
    assert (t.depth, t.key_bits) == (j.depth, j.key_bits)
    np.testing.assert_array_equal(t.bounds.numpy(), np.asarray(j.bounds))
    np.testing.assert_array_equal(t.key.numpy(), np.asarray(j.key))
    np.testing.assert_array_equal(t.payload.numpy(), np.asarray(j.payload))


@pytest.mark.parametrize("depth", [1, 3, 6])
def test_tree_bounds_are_partition_spans(depth):
    (jr, _), (tr, _) = _workload()
    cr = tcrk.crack_to(tcrk.crack_relation(tr), depth)
    assert cr.key_bits == KB
    key, bounds = cr.key.numpy(), cr.bounds.numpy()
    bucket = key >> (cr.key_bits - depth)
    assert bounds[0] == 0 and bounds[-1] == NR
    assert bounds.size == (1 << depth) + 1
    for p in range(1 << depth):
        assert (bucket[bounds[p]:bounds[p + 1]] == p).all()
    assert (np.diff(bucket) >= 0).all()
    _same_store(cr, jcrk.crack_to(jcrk.crack_relation(jr), depth))


def test_crack_reuse_is_lazy(monkeypatch):
    """A second join on the same stores at the same depth runs no crack
    sort and returns the same objects and the same answer."""
    (jr, js), (tr, ts) = _workload()
    crR, crS = tcrk.crack_relation(tr, KB), tcrk.crack_relation(ts, KB)
    pt1 = PhaseTimer("cpu")
    out1, crR, crS = tcrk.crk_join_cracked(crR, crS, TConfig(), 4, pt1)
    assert "partition" in pt1.t.phases
    sorts = []
    level = tcrk._crack_level
    monkeypatch.setattr(tcrk, "_crack_level",
                        lambda *a: sorts.append(a[2]) or level(*a))
    pt2 = PhaseTimer("cpu")
    out2, crR2, crS2 = tcrk.crk_join_cracked(crR, crS, TConfig(), 4, pt2)
    assert "partition" not in pt2.t.phases and sorts == []
    assert crR2 is crR and crS2 is crS
    # a shallower query reuses the deeper stores as they are
    out3, crR3, _ = tcrk.crk_join_cracked(crR, crS, TConfig(), 2)
    assert crR3 is crR and sorts == []
    jout, jR, jS = jcrk.crk_join_cracked(
        jcrk.crack_relation(jr, KB), jcrk.crack_relation(js, KB),
        JConfig(), 4)
    want = (int(jout.matches), int(jout.checksum))
    assert want[0] == NS
    for out in (out1, out2, out3):
        assert (int(out.matches), int(out.checksum)) == want
    _same_store(crR, jR)
    _same_store(crS, jS)


@pytest.mark.parametrize("per_level", [False, True])
def test_deeper_query_refines_incrementally(monkeypatch, per_level):
    """Depth 2 -> 4 cracks only the two missing levels: one sort, or one
    a level; the layout equals a crack to 4 from scratch and the
    reference's."""
    (jr, _), (tr, _) = _workload()
    crR = tcrk.crack_to(tcrk.crack_relation(tr, KB), 2)
    assert crR.depth == 2
    sorts = []
    level = tcrk._crack_level
    monkeypatch.setattr(tcrk, "_crack_level",
                        lambda *a: sorts.append(a[2]) or level(*a))
    pt = PhaseTimer("cpu")
    crR4 = tcrk.crack_to(crR, 4, pt, per_level=per_level)
    assert crR4.depth == 4 and "partition" in pt.t.phases
    assert sorts == ([3, 4] if per_level else [4])
    direct = tcrk.crack_to(tcrk.crack_relation(tr, KB), 4)
    for a, b in ((crR4.key, direct.key), (crR4.payload, direct.payload),
                 (crR4.bounds, direct.bounds)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    jR = jcrk.crack_to(jcrk.crack_to(jcrk.crack_relation(jr, KB), 2), 4,
                       per_level=per_level)
    _same_store(crR4, jR)


@pytest.mark.parametrize("depth", [3, 5])
def test_windowed_materialize_multiset(depth):
    """The windowed join (profile_phases) materialized: cap_s rows a
    partition, its live rows equal the reference's and the global join's
    as multisets."""
    (jr, js), (tr, ts) = _workload()
    cfg = dict(materialize=True, profile_phases=True)
    out, crR, crS = tcrk.crk_join_cracked(
        tcrk.crack_relation(tr, KB), tcrk.crack_relation(ts, KB),
        TConfig(**cfg), depth)
    jout, _, _ = jcrk.crk_join_cracked(
        jcrk.crack_relation(jr, KB), jcrk.crack_relation(js, KB),
        JConfig(**cfg), depth)
    ref = tmergejoin.merge_join_materialize(tr.key, tr.payload, ts.key,
                                            ts.payload, NS)
    assert int(out.matches) == int(jout.matches) == NS
    assert int(out.checksum) == int(jout.checksum) == int(ref.checksum)
    cap_s = tcrk._window_cap(crS.bounds)
    assert out.key.numel() == np.asarray(jout.key).size == cap_s << depth

    def rows(o):
        k = np.asarray(o.key)
        live = k != -3
        return sorted(zip(k[live].tolist(),
                          np.asarray(o.r_payload)[live].tolist(),
                          np.asarray(o.s_payload)[live].tolist()))

    assert rows(out) == rows(jout) == rows(ref)
    # each window: its live rows first, holes behind
    k = out.key.numpy().reshape(1 << depth, cap_s)
    for p in range(1 << depth):
        m = int((k[p] != -3).sum())
        assert (k[p, :m] != -3).all() and (k[p, m:] == -3).all()
        assert m == int(crS.bounds[p + 1] - crS.bounds[p])


def test_stores_of_two_domains_are_refused():
    _, (tr, ts) = _workload()
    with pytest.raises(ValueError, match="same key domain"):
        tcrk.crk_join_cracked(tcrk.crack_relation(tr, KB),
                              tcrk.crack_relation(ts, KB + 1), TConfig(), 3)

"""The port's no-partition build/probe pipeline (ops/kernels/nphj.py, its
plain versions on the CPU) against the JAX package's
(aqp_tpu/ops/pallas/nphj.py) run with its Pallas kernels in interpret mode,
on the same numpy inputs at a small geometry.

The reference's four interpret-mode calls (build, a checksummed and a
keys-only probe of that table, the materializing join) run once per module.
Integers are compared exactly; the materialized columns are region-chunked
in both packages, in different orders within a region, so their live
(key, R payload, S payload) rows are compared as multisets, with the
length and the hole count.  Port-only cases run geometries where the table
and S have different run counts, against the exact core."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.ops.pallas import nphj as jn
from aqp_tpu.ops.pallas import rho3 as jrho3
from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.ops.kernels import nphj as tn
from aqp_tpu_torch.ops.kernels import rho3 as trho3

GEOM = dict(block_rows=64, slot_rows=8, f1=16, f2=4, kd_slot_rows=16)
JPRM = jrho3.Rho3Params(**GEOM)
TPRM = trho3.Rho3Params(**GEOM)
NR, NS = 4096, 16384


def _inputs(nr=NR, ns=NS, seed=31):
    rng = np.random.default_rng(seed)
    rk = (rng.permutation(nr) + 1).astype(np.int32)
    sk = rng.integers(1, 2 * nr, ns).astype(np.int32)    # ~50% hit rate
    rp, sp = (rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
              for n in (nr, ns))
    return rk, rp, sk, sp


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _live(k, a, b):
    k, a, b = (np.asarray(x) for x in (k, a, b))
    m = k != -3
    return sorted(zip(k[m].tolist(), a[m].tolist(), b[m].tolist()))


@pytest.fixture(scope="module")
def ref():
    """The reference's outputs: its table, two probes and the materialize."""
    rk, rp, sk, sp = (jnp.asarray(a) for a in _inputs())
    tk2, tp2, bovf = jn.nphj_build(rk, rp, JPRM, interpret=True)
    probe = {cs: jn.nphj_probe(tk2, tp2, bovf, sk, sp, JPRM, interpret=True,
                               with_checksum=cs) for cs in (True, False)}
    mat = jn.nphj_join_materialize(rk, rp, sk, sp, prm=JPRM, interpret=True)
    return {"table": (np.array(tk2), np.array(tp2), int(bovf)),
            "probe": {cs: tuple(int(x) for x in out)
                      for cs, out in probe.items()},
            "mat": (int(mat[0]), int(mat[1]), *(np.asarray(x)
                                                for x in mat[2:5]),
                    int(mat[5]))}


def test_build_fills_the_reference_table(ref):
    """Every fine slot holds the (key, payload) pairs of its bucket that
    the reference's slot holds.  The reference cuts its slots out of a
    sorted block by whole 128-wide rows, so a slot of it may also carry
    elements of the next bucket; those are left out of the comparison."""
    rk, rp, _, _ = _inputs()
    tk2, tp2, tcnt, ovf = tn.nphj_build(*_t(rk, rp), TPRM)
    jk, jp, jovf = ref["table"]
    assert int(ovf) == jovf == 0
    f1, nbg, f2, cap2 = tk2.shape
    assert jk.shape == (f1, nbg, f2, TPRM.kd_slot_rows, 128)
    jk = jk.reshape(f1, nbg, f2, cap2)
    jp = jp.reshape(f1, nbg, f2, cap2)
    bucket = trho3._fine_bucket(torch.from_numpy(jk),
                                trho3.default_scale(TPRM), TPRM.gmax).numpy()
    assert int(tcnt.sum()) == NR
    for a, j, b in np.ndindex(f1, nbg, f2):
        mine = bucket[a, j, b] == a * f2 + b
        n = int(tcnt[a, j, b])
        assert sorted(zip(jk[a, j, b][mine], jp[a, j, b][mine])) == sorted(
            zip(tk2[a, j, b][:n].tolist(), tp2[a, j, b][:n].tolist()))


@pytest.mark.parametrize("with_checksum", [True, False],
                         ids=["sum", "keys"])
def test_count_and_probe_match_reference(ref, with_checksum):
    rk, rp, sk, sp = _t(*_inputs())
    m, c, ovf = ref["probe"][with_checksum]
    want = (m, c if with_checksum else 0, ovf)
    assert ovf == 0 and m == int((sk <= NR).sum())
    got = tn.nphj_join_count(rk, rp, sk, sp, prm=TPRM,
                             with_checksum=with_checksum)
    assert tuple(int(x) for x in got) == want
    assert got[0].dtype == got[1].dtype == torch.int64
    # one table, probed twice (the second time by other S rows too)
    table = tn.nphj_build(rk, rp, TPRM, with_payload=with_checksum)
    for _ in range(2):
        got = tn.nphj_probe(*table, sk, sp, TPRM,
                            with_checksum=with_checksum)
        assert tuple(int(x) for x in got) == want
    half = tn.nphj_probe(*table, sk[::2], sp[::2], TPRM,
                         with_checksum=with_checksum)
    exact = mergejoin.merge_join_count(rk, rp, sk[::2], sp[::2])
    assert int(half[0]) == int(exact.matches)
    assert int(half[1]) == (int(exact.checksum) if with_checksum else 0)


def test_materialize_matches_reference(ref):
    m, c, jk, jrp, jsp, jovf = ref["mat"]
    tm, tc, tk, trp, tsp, tovf = tn.nphj_join_materialize(
        *_t(*_inputs()), prm=TPRM)
    assert jovf == int(tovf) == 0
    assert (int(tm), int(tc)) == (m, c) == ref["probe"][True][:2]
    assert tk.numel() == jk.size                     # the same length
    assert tk.dtype == trp.dtype == tsp.dtype == torch.int32
    holes = tk.numpy() == -3
    assert int(holes.sum()) == int((jk == -3).sum()) == tk.numel() - m
    assert not trp.numpy()[holes].any() and not tsp.numpy()[holes].any()
    assert _live(tk, trp, tsp) == _live(jk, jrp, jsp)


@pytest.mark.parametrize("nr,ns", [(4096, 1 << 18), (1 << 18, 4096)],
                         ids=["S-more-runs", "R-more-runs"])
def test_unequal_run_counts_against_the_exact_core(nr, ns):
    """nbg_r != nbg_s: K3TWO searches every table run and the materialized
    chunk (2 * max(nbg_r, nbg_s) * cap2 per region) has holes past the S
    runs."""
    rk, rp, sk, sp = _t(*_inputs(nr, ns, seed=8))
    exact = mergejoin.merge_join_count(rk, rp, sk, sp)
    table = tn.nphj_build(rk, rp, TPRM)
    nbg_r = table[0].shape[1]
    m, c, ovf = tn.nphj_probe(*table, sk, sp, TPRM)
    assert int(ovf) == 0
    assert (int(m), int(c)) == (int(exact.matches), int(exact.checksum))
    tm, tc, tk, trp, tsp, tovf = tn.nphj_join_materialize(rk, rp, sk, sp,
                                                          prm=TPRM)
    nbg_s = trho3.num_blocks(ns, TPRM) // TPRM.group
    assert nbg_r != nbg_s and int(tovf) == 0
    chunk = 2 * max(nbg_r, nbg_s) * TPRM.cap2
    assert tk.numel() == TPRM.f1 * TPRM.f2 * chunk
    assert (int(tm), int(tc)) == (int(exact.matches), int(exact.checksum))
    assert int((tk == -3).sum()) == tk.numel() - int(tm)
    dense = mergejoin.merge_join_materialize(rk, rp, sk, sp, ns)
    assert _live(tk, trp, tsp) == _live(dense.key, dense.r_payload,
                                        dense.s_payload)


def test_duplicate_r_keys_count_each_s_row_once():
    rng = np.random.default_rng(9)
    rk = rng.integers(1, 1500, NR).astype(np.int32)
    sk = rng.integers(1, 3000, NS).astype(np.int32)
    rp, sp = (np.zeros(n, np.int32) for n in (NR, NS))
    m, _, ovf = tn.nphj_join_count(*_t(rk, rp, sk, sp), prm=TPRM)
    assert int(ovf) == 0
    assert int(m) == int(np.isin(sk, rk).sum())


def test_variant_geometries_match_reference():
    assert set(tn.VARIANT_PARAMS) == set(jn.VARIANT_PARAMS)
    for name, prm in jn.VARIANT_PARAMS.items():
        assert tn.VARIANT_PARAMS[name].__dict__ == prm.__dict__
    for pipes in (tn.VARIANT_PIPELINES, tn.VARIANT_PIPELINES_SKEW):
        assert set(pipes) == set(jn.VARIANT_PARAMS)


def test_probe_rejects_a_table_of_another_geometry():
    rk, rp, sk, sp = _t(*_inputs(512, 1024))
    table = tn.nphj_build(rk, rp, TPRM, with_payload=False)
    with pytest.raises(ValueError, match="without payloads"):
        tn.nphj_probe(*table, sk, sp, TPRM)
    other = trho3.Rho3Params(**dict(GEOM, f2=8))
    with pytest.raises(ValueError, match="not prm's"):
        tn.nphj_probe(*table, sk, sp, other, with_checksum=False)


def test_cpu_run_launches_no_kernel():
    before = dict(tn.LAUNCHES)
    tn.nphj_join_count(*_t(*_inputs(512, 1024)), prm=TPRM)
    tn.nphj_join_materialize(*_t(*_inputs(512, 1024)), prm=TPRM)
    assert tn.LAUNCHES == before

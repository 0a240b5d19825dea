"""The port's materializing rho3 join against the JAX package's, on the CPU.

The JAX side runs rho_join_materialize_v3 with its Pallas kernels in
interpret mode at the SMALL and HYBRID geometries of tests/test_rho3.py;
the port takes its plain versions.  The columns are region-chunked in both,
in different orders, so the live (key, R payload, S payload) rows are
compared as multisets; everything else is compared exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.ops.pallas import rho3 as jrho3
from aqp_tpu_torch.ops.kernels import rho3 as trho3

GEOMS = {
    "small": dict(block_rows=64, slot_rows=8, f1=16, f2=4, kd_slot_rows=16),
    "hybrid": dict(block_rows=128, slot_rows=8, f1=20, f2=4, kd_slot_rows=16),
}
NR, NS = 3000, 10000


def _inputs(seed):
    rng = np.random.default_rng(seed)
    rk = rng.permutation(NR).astype(np.int32) + 1
    rp = rng.integers(-(1 << 31), 1 << 31, NR, dtype=np.int64)
    sk = rng.integers(1, 2 * NR, NS).astype(np.int32)      # ~50% hit rate
    sp = rng.integers(-(1 << 31), 1 << 31, NS, dtype=np.int64)
    return rk, rp.astype(np.int32), sk, sp.astype(np.int32)


def _live(k, a, b):
    k, a, b = (np.asarray(x) for x in (k, a, b))
    m = k != -3
    return sorted(zip(k[m].tolist(), a[m].tolist(), b[m].tolist()))


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_materialize_matches_reference(geom):
    rk, rp, sk, sp = _inputs(11)
    jprm = jrho3.Rho3Params(**GEOMS[geom])
    tprm = trho3.Rho3Params(**GEOMS[geom])
    jm, jc, jk, jrp, jsp, jovf = jrho3.rho_join_materialize_v3(
        *(jnp.asarray(a) for a in (rk, rp, sk, sp)), prm=jprm,
        interpret=True)
    tm, tc, tk, trp, tsp, tovf = trho3.rho_join_materialize_v3(
        *(torch.from_numpy(a) for a in (rk, rp, sk, sp)), prm=tprm)
    assert int(jovf) == 0 and int(tovf) == 0
    assert (int(tm), int(tc)) == (int(jm), int(jc))
    assert tk.numel() == np.asarray(jk).size          # the same length
    assert tk.dtype == trp.dtype == tsp.dtype == torch.int32
    assert _live(tk, trp, tsp) == _live(jk, jrp, jsp)
    holes = tk.numpy() == -3
    assert int(holes.sum()) == tk.numel() - int(tm)
    assert not trp.numpy()[holes].any() and not tsp.numpy()[holes].any()
    # and the count pipeline agrees with the materializer
    cm, cc, _ = trho3.rho_join_count_v3(
        *(torch.from_numpy(a) for a in (rk, rp, sk, sp)), prm=tprm)
    assert (int(cm), int(cc)) == (int(tm), int(tc))


@pytest.mark.parametrize("salt", jrho3.RETRY_SALTS)
def test_modinv_matches_reference(salt):
    want = int(jrho3._modinv_pow2(jnp.int32(salt)))
    assert trho3._modinv_pow2(salt) == want == pow(salt, -1, 1 << 30)


def test_k3m_plain_rule_on_duplicate_r_keys():
    """K3M answers with the R copy K3 counts: the first run that holds the
    partner, its lowest (key, payload) copy, so columns and scalars
    agree."""
    rng = np.random.default_rng(5)
    rk = rng.integers(1, 600, 2000).astype(np.int32)        # duplicates
    rp = rng.integers(-(1 << 31), 1 << 31, 2000, dtype=np.int64).astype(
        np.int32)
    sk = rng.integers(1, 1200, 6000).astype(np.int32)
    sp = rng.integers(-(1 << 31), 1 << 31, 6000, dtype=np.int64).astype(
        np.int32)
    prm = trho3.Rho3Params(**GEOMS["hybrid"])
    t = [torch.from_numpy(a) for a in (rk, rp, sk, sp)]
    k2, p2, cnt2, ovf = trho3._partition_2level(*t, prm, trho3.HASH_C, True,
                                                None)
    assert int(ovf) == 0
    inv = trho3._modinv_pow2(trho3.HASH_C)
    m, c, ok, orp, osp = trho3.k3m_plain(k2, p2, cnt2, inv)
    assert (int(m), int(c)) == tuple(int(x) for x in trho3.k3_plain(k2, p2,
                                                                   cnt2))
    live = ok.numpy() != -3
    assert int(live.sum()) == int(m) == int(np.isin(sk, rk).sum())
    got_ck = (orp.numpy()[live].astype(np.int64) & 0xFFFFFFFF).sum() + (
        osp.numpy()[live].astype(np.int64) & 0xFFFFFFFF).sum()
    assert int(got_ck) & 0xFFFFFFFF == int(c)
    # every live row is a real (key, R payload of that key, S payload) triple
    r_pairs = set(zip(rk.tolist(), rp.tolist()))
    s_pairs = set(zip(sk.tolist(), sp.tolist()))
    for k, a, b in zip(ok.numpy()[live].tolist(), orp.numpy()[live].tolist(),
                       osp.numpy()[live].tolist()):
        assert (k, a) in r_pairs and (k, b) in s_pairs


def test_cpu_materialize_launches_no_kernel():
    rk, rp, sk, sp = _inputs(2)
    before = dict(trho3.LAUNCHES)
    trho3.rho_join_materialize_v3(
        *(torch.from_numpy(a) for a in (rk, rp, sk, sp)),
        prm=trho3.Rho3Params(**GEOMS["small"]))
    assert trho3.LAUNCHES == before

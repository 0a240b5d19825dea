"""The port's rho3 front end against the JAX package's, on the CPU.

Inputs are made with numpy and fed to both packages; the JAX side runs its
Pallas kernels in interpret mode at the small geometries of
tests/test_rho3.py.  Every comparison is exact: these are integers.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.ops.pallas import netsort as jnet
from aqp_tpu.ops.pallas import rho3 as jrho3
from aqp_tpu_torch.ops.kernels import rho3 as trho3

GEOMS = {
    "small": dict(block_rows=64, slot_rows=8, f1=16, f2=4, kd_slot_rows=16),
    "hybrid": dict(block_rows=128, slot_rows=8, f1=20, f2=4, kd_slot_rows=16),
}
NR, NS = 4096, 16384   # one shape for every JAX call: one compile each


def _params(geom):
    return jrho3.Rho3Params(**GEOMS[geom]), trho3.Rho3Params(**GEOMS[geom])


def _fk(seed):
    rng = np.random.default_rng(seed)
    rk = rng.permutation(NR).astype(np.int32) + 1
    sk = np.concatenate([rng.permutation(NR) + 1
                         for _ in range(NS // NR)]).astype(np.int32)
    pay = rng.integers(-(1 << 31), 1 << 31, NR + NS, dtype=np.int64)
    return rk, sk, pay.astype(np.int32)


def test_constants_match():
    for name in ("MAX_KEY", "PAD_R_INPUT", "PAD_S_INPUT", "HASH_C",
                 "HASH_MASK", "RETRY_SALTS"):
        assert getattr(trho3, name) == getattr(jrho3, name), name
    assert trho3.KEY_PAD_INT == jnet.KEY_PAD_INT
    assert trho3.Rho3Params() == trho3.Rho3Params(
        **vars(jrho3.Rho3Params()))


@pytest.mark.parametrize("salt", jrho3.RETRY_SALTS)
def test_pack_keys_bitwise(salt):
    rng = np.random.default_rng(1)
    alias_key = (pow(salt, -1, 1 << 30) * jrho3.HASH_MASK) % (1 << 30)
    edge = [0, 1, jrho3.MAX_KEY - 1, jrho3.MAX_KEY, jrho3.PAD_S_INPUT,
            1 << 30, (1 << 31) - 1, -1, -(1 << 31), alias_key]
    key = np.concatenate([
        rng.integers(-(1 << 31), 1 << 31, 4096, dtype=np.int64),
        rng.integers(0, 1 << 30, 4096), edge]).astype(np.int32)
    tag = rng.integers(0, 2, key.size).astype(np.int32)
    jp, ja = jrho3.pack_keys(jnp.asarray(key), jnp.asarray(tag), salt)
    tp, ta = trho3.pack_keys(torch.from_numpy(key), torch.from_numpy(tag),
                             salt)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    viol = int(np.sum((key.astype(np.int64) < 0) | (key >= (1 << 30))))
    assert int(ta) == int(ja)
    assert int(ta) >= viol + 1      # the aliasing key is reported


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_fine_bucket_bitwise(geom):
    jprm, tprm = _params(geom)
    gmax = jprm.f1 * jprm.f2
    rng = np.random.default_rng(2)
    packed = np.concatenate([
        rng.integers(0, jnet.KEY_PAD_INT, 1 << 16),
        [0, 1, 2, jnet.KEY_PAD_INT - 1, jnet.KEY_PAD_INT, jnet.KEY_PAD_LOW,
         -5]]).astype(np.int32)
    default = jnp.float32(gmax / (1 << 30) * (1.0 - 1e-6))
    assert trho3.default_scale(tprm) == float(default)
    for scale in (default, jnp.float32(gmax / float(1 << 20))):
        want = jrho3._fine_bucket(jnp.asarray(packed), scale, gmax)
        got = trho3._fine_bucket(torch.from_numpy(packed), float(scale),
                                 gmax)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _slot_pairs(keys, pays):
    """Per slot, the sorted (key, payload as unsigned) pairs as one int64,
    both pad kinds mapped to (KEY_PAD_INT, 0)."""
    keys = keys.astype(np.int64)
    pad = (keys == jnet.KEY_PAD_INT) | (keys == jnet.KEY_PAD_LOW)
    pays = np.where(pad, 0, pays.astype(np.int64) & 0xFFFFFFFF)
    keys = np.where(pad, jnet.KEY_PAD_INT, keys)
    return np.sort((keys << 32) | pays, axis=-1)


@pytest.mark.parametrize("with_payload", [False, True],
                         ids=["keys", "payload"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_route_2level_slots(geom, with_payload):
    """After K1 + K2 every fine slot holds the same real elements as the
    reference's wherever the reference reports no overflow."""
    jprm, tprm = _params(geom)
    rk, sk, pay = _fk(3)
    key = np.concatenate([rk, sk])
    tag = np.concatenate([np.zeros(NR, np.int32), np.ones(NS, np.int32)])
    packed, _ = jrho3.pack_keys(jnp.asarray(key), jnp.asarray(tag),
                                jrho3.HASH_C)
    packed = np.array(packed)
    jk, jp, jnbg, jovf = jrho3.route_2level(
        jnp.asarray(packed), jnp.asarray(pay) if with_payload else None,
        jprm, interpret=True, with_payload=with_payload)
    tk, tp, tcnt, tnbg, tovf = trho3.route_2level(
        torch.from_numpy(packed), torch.from_numpy(pay), tprm,
        with_payload)
    assert int(jovf) == 0
    assert int(tovf) == 0
    assert tnbg == jnbg
    shape = (jprm.f1, jnbg, jprm.f2, tprm.cap2)
    jk = np.asarray(jk).reshape(shape)
    real = (jk != jnet.KEY_PAD_INT) & (jk != jnet.KEY_PAD_LOW)
    np.testing.assert_array_equal(tcnt.numpy(), real.sum(-1))
    # real keys sorted, pads behind: the port's slot layout
    want = np.sort(np.where(real, jk, jnet.KEY_PAD_INT), axis=-1)
    np.testing.assert_array_equal(tk.numpy(), want)
    if with_payload:
        np.testing.assert_array_equal(
            _slot_pairs(tk.numpy(), tp.numpy()),
            _slot_pairs(jk, np.asarray(jp).reshape(shape)))
    else:
        assert tp is None

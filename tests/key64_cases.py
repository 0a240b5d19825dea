"""Shared cases of the key64 tests (test_torch_key64*.py): the Python
truth, the port's and the JAX package's runs on the same numpy arrays, and
the comparison of their results."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from aqp_tpu import JoinConfig as JConfig
from aqp_tpu import run_join as jrun
from aqp_tpu.relation import Relation as JRelation
from aqp_tpu_torch.config import JoinConfig as TConfig
from aqp_tpu_torch.joins.api import JOIN_ALGORITHMS
from aqp_tpu_torch.joins.api import run_join as trun
from aqp_tpu_torch.relation import Relation as TRelation

NAMES = sorted(JOIN_ALGORITHMS)
MODES = {"keys": {"checksum": False}, "sum": {},
         "materialize": {"materialize": True}}
NR, NS = 1 << 10, 1 << 12
HI = 1 << 40
U32 = (1 << 32) - 1


def x64():
    """The reference needs jax_enable_x64 for int64 arrays: a module
    fixture of each key64 test file sets it and restores it after."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", before)


def truth(rk, rp, sk, sp):
    """(matches, checksum mod 2^32, sorted live rows) with unique R keys,
    in Python integers."""
    lut = dict(zip(rk.tolist(), rp.tolist()))
    rows = sorted((k, lut[k], p) for k, p in zip(sk.tolist(), sp.tolist())
                  if k in lut)
    return len(rows), sum(r + p for _, r, p in rows) & U32, rows


def live_rows(res, keep=lambda x: x):
    """The materialized result's live rows (key != -3), sorted."""
    k = res.key.numpy() if isinstance(res.key, torch.Tensor) else \
        np.asarray(res.key)
    rp, sp = (np.asarray(c) for c in (res.r_payload, res.s_payload))
    live = k != -3
    return sorted(zip(k[live].tolist(), map(keep, rp[live].tolist()),
                      sp[live].tolist()))


def sparse_arrays(seed=42):
    """R: a permutation of 1..NR above 2^40; S: R's keys drawn at random,
    the first 16 set to (2^40 + 1) + 2^32, which equals R's key 2^40 + 1
    in its low 32 bits but is no R key; payloads beyond 32 bits."""
    rng = np.random.default_rng(seed)
    rk = rng.permutation(NR).astype(np.int64) + 1 + HI
    rp = rng.integers(-(1 << 40), 1 << 40, NR)
    sk = rk[rng.integers(0, NR, NS)]
    sk[:16] = HI + 1 + (1 << 32)
    sp = rng.integers(-(1 << 40), 1 << 40, NS)
    return rk, rp, sk, sp


_REF: dict = {}


def reference(name, mode, arrays):
    """The JAX package's result (cached per name, mode and arrays)."""
    key = (name, mode, id(arrays))
    if key not in _REF:
        rk, rp, sk, sp = arrays
        res, _ = jrun(JRelation(jnp.asarray(rk), jnp.asarray(rp)),
                      JRelation(jnp.asarray(sk), jnp.asarray(sp)), name,
                      JConfig(key64=True, **MODES[mode]))
        _REF[key] = res
    return _REF[key]


def port(name, arrays, key64=True, **fields):
    rk, rp, sk, sp = arrays
    res, t = trun(TRelation.from_numpy(rk, rp, device="cpu"),
                  TRelation.from_numpy(sk, sp, device="cpu"), name,
                  TConfig(key64=key64, **fields), device="cpu")
    assert t.matches == int(res.matches)
    return res


def check_against(res, mode, want, ref=None, name=""):
    """Hold a port result to the truth and, given, to the reference."""
    matches, checksum, rows = want
    assert int(res.matches) == matches
    if mode != "keys":
        assert int(res.checksum) == checksum
    if ref is not None:
        assert int(res.matches) == int(ref.matches)
        if mode == "sum":
            assert int(res.checksum) == int(ref.checksum)
    if mode == "materialize":
        # int64 columns, never cut to int32
        assert res.key.dtype == res.r_payload.dtype == torch.int64
        assert res.s_payload.dtype == torch.int64
        assert live_rows(res) == rows
        if ref is not None:
            # the reference's NL materializes its R payloads as int32:
            # compare their low 32 bits there
            cut = (lambda x: x & U32) if name == "NL" else (lambda x: x)
            assert live_rows(res, cut) == live_rows(ref, cut)
    else:
        assert not res.materialized

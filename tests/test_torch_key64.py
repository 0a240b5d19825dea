"""64-bit keys through every join name of the port, on the CPU: sparse keys
above 2^40 with S keys that alias an R key under a 32-bit cut, held to the
JAX package (int64 under jax_enable_x64, scoped to this module) and to the
Python truth; keys at the ends of the int64 range, held to the truth; no
kernel wrapper is ever called for an int64 key; the generators' int64 draws
equal their int32 draws.  Dense int64 keys: test_torch_key64_dense.py."""

import sys

import numpy as np
import pytest
import torch

from aqp_tpu_torch.data import generator as gen
from aqp_tpu_torch.ops.kernels import (aggpipe, blocksort, compact,
                                       lanecompact, nphj, rho3, rstats,
                                       scan)
from key64_cases import (HI, MODES, NAMES, NS, check_against, port,
                         reference, sparse_arrays, truth, x64)

_x64 = pytest.fixture(scope="module", autouse=True)(x64)
SPARSE = sparse_arrays()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", NAMES)
def test_sparse_keys_above_2_40_with_alias_trap(name, mode):
    res = port(name, SPARSE, **MODES[mode])
    want = truth(*SPARSE)
    assert want[0] == NS - 16
    check_against(res, mode, want, reference(name, mode, SPARSE), name)


@pytest.mark.parametrize("name", NAMES)
def test_key64_flag_off_serves_int64_by_dtype(name):
    """As in the reference, the keys' dtype decides: JoinConfig(key64=
    False) with int64 keys gives the same answer."""
    res = port(name, SPARSE, key64=False)
    assert (int(res.matches), int(res.checksum)) == truth(*SPARSE)[:2]


# The ends of the int64 range: 2^62 and -2^62 (equal mod 2^63), 2^63 - 1
# and -1, -2^63 and 0 (each pair equal mod 2^63), and 2^63 - 1, the staged
# open-addressing table's EMPTY marker, as a real key in R (EDGE) or in S
# only (EDGE_NO_MAX).
_EDGE_R = [1, 2, 3, 1 << 62, (1 << 63) - 1, 5]
_EDGE_S = [1, 2, -(1 << 62), -1, 0, (1 << 63) - 1, (1 << 63) - 2, -(1 << 63)]


def _edge(rkeys):
    rk = np.array(rkeys, np.int64)
    rp = (np.arange(10, 10 + rk.size, dtype=np.int64) << 40) + 7
    sk = np.array(_EDGE_S, np.int64)
    sp = (np.arange(20, 20 + sk.size, dtype=np.int64) << 35) * -1 + 3
    return rk, rp, sk, sp


EDGES = {"max_in_R": _edge(_EDGE_R),
         "max_in_S_only": _edge([1, 2, 3, 1 << 62, 5, -(1 << 63)])}
EDGE_MODES = {**MODES, "staged": {"profile_phases": True},
              "staged_materialize": {"profile_phases": True,
                                     "materialize": True}}


@pytest.mark.parametrize("edge", list(EDGES))
@pytest.mark.parametrize("mode", list(EDGE_MODES))
@pytest.mark.parametrize("name", NAMES)
def test_exact_at_the_ends_of_the_int64_range(name, mode, edge):
    """Three true matches in either pair; the reference's int64 sort
    cores pack k << 1 and wrap here (ROADMAP C, quirks)."""
    arrays = EDGES[edge]
    want = truth(*arrays)
    assert want[0] == 3
    res = port(name, arrays, **EDGE_MODES[mode])
    check_against(res, mode.replace("staged_", "").replace("staged", "sum"),
                  want)


# keys the gate refuses: a dtype other than int32 and int64, and R and S
# of two dtypes
REFUSED = {"int16": (np.int16, np.int16), "int32_R_int64_S": (np.int32,
                                                             np.int64)}


@pytest.mark.parametrize("dtypes", list(REFUSED))
@pytest.mark.parametrize("name", NAMES)
def test_refuses_other_and_mixed_key_dtypes(name, dtypes):
    rk, rp, sk, sp = sparse_arrays(3)
    rdt, sdt = REFUSED[dtypes]
    arrays = ((rk - HI).astype(rdt), rp.astype(rdt), (sk - HI).astype(sdt),
              sp.astype(sdt))
    with pytest.raises(TypeError, match="int32 or int64 keys of one dtype"):
        port(name, arrays, key64=False)


WRAPPERS = {rho3: ("k1", "k2", "k3", "k3m"), nphj: ("k3two", "k3two_mat"),
            aggpipe: ("k3agg",), rstats: ("r_cand_stats_kernel",),
            lanecompact: ("_compact_windows",),
            compact: ("sort_hist", "scatter_segments",
                      "scatter_segments_one"),
            blocksort: ("sort_blocks", "tile_plan"),
            scan: ("count", "sum_", "bitvector")}


@pytest.fixture
def no_kernels(monkeypatch):
    """Every kernel wrapper replaced, wherever the port's modules hold it,
    by one that fails; every LAUNCHES counter checked after."""
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called")

    wrappers = {id(getattr(m, n)) for m, names in WRAPPERS.items()
                for n in names}
    for modname, mod in list(sys.modules.items()):
        if modname.startswith("aqp_tpu_torch") and mod is not None:
            for attr, val in list(vars(mod).items()):
                if id(val) in wrappers and callable(val):
                    monkeypatch.setattr(mod, attr, boom)
    before = [dict(m.LAUNCHES) for m in WRAPPERS]
    yield
    assert before == [dict(m.LAUNCHES) for m in WRAPPERS]


def test_the_wrapper_patch_catches_an_int32_call(no_kernels):
    """The patch is live: the same join on int32 keys reaches a kernel
    wrapper (its plain version, on the CPU) and fails."""
    rk, rp, sk, sp = sparse_arrays(1)
    rk, sk = (rk - HI).astype(np.int32), (sk - HI).astype(np.int32)
    sk[:16] = 2
    rp, sp = rp.astype(np.int32), sp.astype(np.int32)
    with pytest.raises(AssertionError, match="kernel wrapper"):
        port("RHO", (rk, rp, sk, sp), dense_path=False)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", NAMES)
def test_int64_keys_call_no_kernel(no_kernels, name, mode):
    res = port(name, SPARSE, dense_path=False, **MODES[mode])
    check_against(res, mode, truth(*SPARSE))


GENERATORS = {
    "pk": lambda dt, p: gen.create_relation_pk(3000, dtype=dt, device="cpu",
                                               random_payload=p),
    "fk": lambda dt, p: gen.create_relation_fk(7000, 3000, dtype=dt,
                                               device="cpu",
                                               random_payload=p),
    "fk_sel_tiled": lambda dt, p: gen.create_relation_fk_sel(
        7000, 3000, 50.0, dtype=dt, device="cpu", random_payload=p),
    "fk_sel_drawn": lambda dt, p: gen.create_relation_fk_sel(
        7000, 3000, 5.0, dtype=dt, device="cpu", random_payload=p),
    "zipf": lambda dt, p: gen.create_relation_zipf(7000, 3000, 1.25,
                                                   dtype=dt, device="cpu",
                                                   random_payload=p),
}


@pytest.mark.parametrize("payload", [False, True], ids=["zero", "random"])
@pytest.mark.parametrize("which", list(GENERATORS))
def test_generators_int64_draws_equal_int32_draws(which, payload):
    a = GENERATORS[which](torch.int32, payload)
    b = GENERATORS[which](torch.int64, payload)
    assert a.key.dtype == a.payload.dtype == torch.int32
    assert b.key.dtype == b.payload.dtype == torch.int64
    assert torch.equal(a.key.long(), b.key)
    assert torch.equal(a.payload.long(), b.payload)
    assert bool(a.payload.any()) == payload

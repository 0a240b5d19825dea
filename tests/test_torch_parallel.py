"""The port's distributed layer (aqp_tpu_torch/parallel) against the JAX
package's (aqp_tpu/parallel) on the same numpy inputs, on the CPU.

The port runs as gloo ranks, one process each (bringup.spawn_ranks, one
spawn a world size, every case in it: tests/torch_parallel_cases.py); the
reference as shard_map programs over the first n of conftest's 8 virtual
devices, its shard-local join the exact XLA core.  The inputs come from
the JAX generators with tests/test_distributed.py's seeds (and
__graft_entry__.dryrun_multichip's payloads), carried over as numpy.

Compared: the shuffle's receive buffers, its overflow counts and the heavy
key sets position by position; the joins' (matches, checksum, overflow)
scalars, which every rank must return alike; the materialized columns as
each rank's multiset of live rows.  The port's int64 scalars hold the
reference's int32 / uint32 values (checksums reduced mod 2^32)."""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from aqp_tpu.data import (create_relation_fk, create_relation_pk,
                          create_relation_zipf)
from aqp_tpu.ops.hashing import partition_hash
from aqp_tpu.parallel import dist_join as ref_dj
from aqp_tpu.parallel import mesh as ref_mesh
from aqp_tpu.parallel import shuffle as ref_shuffle
from aqp_tpu.parallel import skew as ref_skew
from aqp_tpu.relation import Relation as JRelation

from aqp_tpu_torch.parallel import bringup
from aqp_tpu_torch.parallel import dist_join as dj
from aqp_tpu_torch.parallel import shuffle, skew
from aqp_tpu_torch.parallel.bringup import initialize_distributed

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_cases as cases  # noqa: E402

NR, NS = 1 << 12, 1 << 14
WORLDS = (8, 3)


def _with_payloads(r, s, rp=None, sp=None):
    rk, sk = np.asarray(r.key), np.asarray(s.key)
    return (rk, rk * 3 + 1 if rp is None else rp,
            sk, sk * 7 + 5 if sp is None else sp)


@functools.lru_cache(maxsize=None)
def inputs() -> dict:
    """name -> (R keys, R payloads, S keys, S payloads), int32 numpy."""
    pk, fk, zipf = create_relation_pk, create_relation_fk, create_relation_zipf
    rng = np.random.default_rng(7)
    mat_pay = [rng.integers(1, 1 << 20, n).astype(np.int32)
               for n in (NR, NS)]
    out = {
        "fk": _with_payloads(pk(NR, seed=11111), fk(NS, NR, seed=22222)),
        "fk2d": _with_payloads(pk(NR, seed=31), fk(NS, NR, seed=32)),
        "mat": _with_payloads(pk(NR, seed=41), fk(NS, NR, seed=42),
                              *mat_pay),
        "ring": _with_payloads(pk(NR, seed=71), fk(NS, NR, seed=72)),
        "z14": _with_payloads(pk(NR), zipf(NS, NR, 1.4)),
        "z15": _with_payloads(pk(NR, seed=51), zipf(NS, NR, 1.5, seed=52)),
        "z125": _with_payloads(pk(NR), zipf(NS, NR, 1.25)),
        "nd1": _with_payloads(pk(NR - 3, seed=61),
                              fk(NS - 5, NR - 3, seed=62)),
        "nd2": _with_payloads(pk(NR - 7, seed=91),
                              fk(NS - 3, NR - 7, seed=92)),
    }
    return {k: tuple(np.ascontiguousarray(c, dtype=np.int32) for c in v)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def port():
    """world -> every rank's results, each world spawned once, on first
    use."""
    got = {}

    def world(n):
        if n not in got:
            got[n] = cases.spawn_cases(n, inputs())
        return got[n]
    return world


def jrel(name, side):
    c = inputs()[name]
    return JRelation(jnp.asarray(c[2 * side]), jnp.asarray(c[2 * side + 1]))


@functools.lru_cache(maxsize=None)
def jmesh(n):
    return ref_mesh.make_mesh(n)


def ints(*xs) -> tuple:
    return tuple(int(x) for x in xs)


def scalars(value) -> tuple:
    return tuple(x for x in value if not isinstance(x, np.ndarray))


def same_on_every_rank(results, case) -> tuple:
    """The case's scalars, which every rank must return alike."""
    first = scalars(results[0][case])
    for rank, r in enumerate(results):
        assert scalars(r[case]) == first, (case, rank, r[case], first)
    return first


# ---------------------------------------------------------------------------
# The slice as a whole: dryrun_multichip's sequence


@functools.lru_cache(maxsize=None)
def ref_count(name, n):
    return ints(*ref_dj.dist_join_count(jrel(name, 0), jrel(name, 1),
                                        jmesh(n)))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_count_equals_the_reference(port, world, engine):
    want = ref_count("fk", world)
    assert want[0] == NS and want[2:] == (0, 0)
    assert same_on_every_rank(port(world), f"count {engine}") == want


@pytest.mark.parametrize("world", WORLDS)
def test_count_non_divisible_sizes(port, world):
    want = ref_count("nd1", world)
    assert want[0] == NS - 5
    assert same_on_every_rank(port(world), "count nondivisible") == want


def test_2d_join_equals_the_reference(port):
    want = ints(*ref_dj.dist_join_count_2d(
        jrel("fk2d", 0), jrel("fk2d", 1), ref_mesh.make_mesh_2d(2, 4)))
    assert want[0] == NS and want[2:] == (0, 0)
    assert same_on_every_rank(port(8), "2d") == want


def _live_rows(k, a, b):
    t = np.stack([k, a, b], 1)[k >= 0].astype(np.int64)
    return t[np.lexsort(t.T[::-1])]


@pytest.mark.parametrize("world", WORLDS)
def test_materialize_per_rank_multisets(port, world):
    m, c, ok, orp, osp, ovf = ref_dj.dist_join_materialize(
        jrel("mat", 0), jrel("mat", 1), jmesh(world))
    want = ints(m, c, ovf)
    assert want[0] == NS and want[2] == 0
    results = port(world)
    assert same_on_every_rank(results, "materialize")[:3] == want
    ok, orp, osp = (np.asarray(x) for x in (ok, orp, osp))
    cap = ok.shape[0] // world
    for rank, r in enumerate(results):
        cut = slice(rank * cap, (rank + 1) * cap)
        np.testing.assert_array_equal(
            r["materialize"][3], _live_rows(ok[cut], orp[cut], osp[cut]),
            err_msg=f"rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name,case", [("ring", "ring"),
                                       ("nd2", "ring nondivisible")])
def test_ring_equals_the_reference(port, world, name, case):
    want = ints(*ref_dj.dist_join_count_ring(jrel(name, 0), jrel(name, 1),
                                             jmesh(world)))
    assert want[0] == inputs()[name][2].size
    assert same_on_every_rank(port(world), case) == want


@pytest.mark.parametrize("world", WORLDS)
def test_skew_tier_equals_the_reference(port, world):
    mesh = jmesh(world)
    R = ref_mesh.shard_relation(jrel("z14", 0), mesh)
    S = ref_mesh.shard_relation(jrel("z14", 1), mesh)
    fn = ref_skew.make_dist_join_count_skew(mesh, R.num_tuples // world,
                                            S.num_tuples // world)
    want = ints(*fn(R.key, R.payload, S.key, S.payload))
    assert want[0] == NS and want[2] == 0
    assert same_on_every_rank(port(world), "skew z=1.4") == want


def test_auto_ends_in_the_skew_tier(port):
    want = ref_dj.dist_join_count_auto(jrel("z15", 0), jrel("z15", 1),
                                       jmesh(8))
    assert want[0] == NS and want[2] == "skew"
    assert same_on_every_rank(port(8), "auto z=1.5") == tuple(want)


@pytest.mark.parametrize("world", WORLDS)
def test_overflow_is_exact_at_z_1_25(port, world):
    """Expected drops computed on the host from the reference's hash and
    capacity (per source block, per destination), as
    test_dist_join_skewed_overflow_reported does."""
    sk = inputs()["z125"][2]
    rows = -(-NS // world)
    cap_s = max(8, int(rows / world * 2.0))
    bits = max(1, (world - 1).bit_length())
    dest = np.asarray(partition_hash(jnp.asarray(sk), bits) % world)
    drop = 0
    for src in range(world):
        d = dest[src * rows:(src + 1) * rows]
        drop += int(np.maximum(np.bincount(d, minlength=world) - cap_s,
                               0).sum())
    m, _, ovf_r, ovf_s = same_on_every_rank(port(world), "overflow z=1.25")
    assert (ovf_s, ovf_r, m) == (drop, 0, NS - drop)
    if world == 8:
        assert drop > 0    # engineered to overflow


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_scalars(port, world):
    results = port(world)
    for case in results[0]:
        if case in ("shard", "shuffle", "heavy"):
            continue
        same_on_every_rank(results, case)



# ---------------------------------------------------------------------------
# Real keys equal to rho3's input pads, and int64 relations, in the
# shard-local "pallas" engine: held to the truth, since the reference's
# engine drops those keys too

PAD_KEYS = (2**30 - 2, 2**30 - 1)
U32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def pad_key_inputs() -> dict:
    """"pads": int32 relations holding both input-pad values as real keys;
    "wide": int64 relations (keys past 2^40, payloads past 32 bits)."""
    rk = np.array([*PAD_KEYS, 5, 7, 9, *range(100, 400)], np.int64)
    sk = np.array([*PAD_KEYS, 5, 5, 9, 11,
                   *np.tile(np.arange(100, 400), 3)], np.int64)
    rng = np.random.default_rng(2021)
    rp, sp = (rng.integers(-(1 << 31), 1 << 31, k.size) for k in (rk, sk))
    wide = [rk + (1 << 40), rng.integers(-(1 << 40), 1 << 40, rk.size),
            sk + (1 << 40), rng.integers(-(1 << 40), 1 << 40, sk.size)]
    return {"pads": tuple(c.astype(np.int32) for c in (rk, rp, sk, sp)),
            "wide": tuple(wide)}


def truth(rk, rp, sk, sp) -> tuple:
    """(matches, checksum): every (R, S) pair of equal keys, the checksum
    the sum of both payloads' low 32 bits mod 2^32."""
    hit = rk[:, None] == sk[None, :]
    ck = (rp.astype(np.int64)[:, None] & U32) + (sp.astype(np.int64) & U32)
    return int(hit.sum()), int(ck[hit].sum()) & U32


@pytest.fixture(scope="module")
def pad_cases():
    """(world, input name) -> every rank's pad_key_cases, each spawned
    once."""
    got = {}

    def world(n, name):
        if (n, name) not in got:
            got[n, name] = cases.spawn_pad_key_cases(
                n, name, pad_key_inputs()[name])
        return got[n, name]
    return world


@pytest.mark.parametrize("world", (1, 3))
def test_pallas_engine_reports_real_input_pad_keys(pad_cases, world):
    """rho3 would drop the keys 2^30 - 2 and 2^30 - 1 unseen: the engine
    reports them as overflow (1-D and 2-D), never a short count."""
    want = truth(*pad_key_inputs()["pads"])
    assert want[0] == 905
    results = pad_cases(world, "pads")
    for case in ("pallas", "2d pallas"):
        m, c, ovf_r, ovf_s = same_on_every_rank(results, case)
        assert ovf_r > 0 and ovf_s == 0, (case, m, ovf_r)
    assert same_on_every_rank(results, "xla") == want + (0, 0)


@pytest.mark.parametrize("world", (1, 3))
def test_auto_on_a_card_answers_real_input_pad_keys(pad_cases, world):
    """With "auto" resolved to "pallas", as on a card, the ladder climbs
    past the reported overflow to the exact core."""
    want = truth(*pad_key_inputs()["pads"])
    assert same_on_every_rank(pad_cases(world, "pads"), "auto") == (
        *want, "hash+salt")


@pytest.mark.parametrize("world", (1, 3))
@pytest.mark.parametrize("case", ["pallas", "2d pallas", "xla", "auto"])
def test_int64_relations_reach_no_kernel(pad_cases, world, case):
    """int64 shards take the exact core under "pallas" too: the answer is
    the truth with every rho3 kernel wrapper made to raise."""
    want = truth(*pad_key_inputs()["wide"])
    assert want[0] == 905
    tail = ("hash",) if case == "auto" else (0, 0)
    assert same_on_every_rank(pad_cases(world, "wide"), case) == (
        *want, *tail)

# ---------------------------------------------------------------------------
# Zipf z = 1.5 S on four ranks: auto's skew tier sizes its heavy buffer from
# the heavy rows a rank holds (C11); the reference's fixed 4,096 overflows


@functools.lru_cache(maxsize=None)
def zipf_inputs() -> tuple:
    """2^14 dense-PK R against 2^16 Zipf z = 1.5 S (seeds 11111 and 22222,
    random payloads), as numpy."""
    from aqp_tpu_torch.experiments import dist_forms

    r, _, z = dist_forms.relations(1 << 14, 1 << 16, "cpu")
    return tuple(t.numpy() for t in (r.key, r.payload, z.key, z.payload))


def test_auto_answers_zipf_1_5_on_four_ranks_in_the_skew_tier():
    cols = zipf_inputs()
    want = cases.truth_pk(*cols)
    assert want[0] == 1 << 16
    got = bringup.spawn_ranks(cases.auto_case, 4, (cols,), timeout_s=240.0)
    assert got == [(*want, "skew")] * 4


def test_reference_auto_overflows_on_zipf_1_5_on_four_devices():
    """The reference keeps its fixed heavy buffer: on the same numpy
    inputs its auto raises (a quirk of the reference, recorded here)."""
    rk, rp, zk, zp = (jnp.asarray(c) for c in zipf_inputs())
    with pytest.raises(RuntimeError, match="overflow beyond every tier"):
        ref_dj.dist_join_count_auto(JRelation(rk, rp), JRelation(zk, zp),
                                    jmesh(4))


# ---------------------------------------------------------------------------
# The modules: the shuffle's buffers, the heavy keys, the shards


@functools.lru_cache(maxsize=None)
def ref_shuffle_and_heavy(n):
    """The reference's receive buffers (R of nd1, S of z125) and heavy keys
    (S of z14) from one shard_map, each as one row a shard."""
    mesh = jmesh(n)
    R = ref_mesh.shard_relation(jrel("nd1", 0), mesh)
    S = ref_mesh.shard_relation(jrel("z125", 1), mesh)
    Z = ref_mesh.shard_relation(jrel("z14", 1), mesh)
    cap_r, cap_s = cases.capacities(NR - 3, NS, n)
    _, cap_z = cases.capacities(NS, NS, n)

    def body(rk, rp, sk, sp, zk):
        a = ref_shuffle.shuffle_relation(rk, rp, "shard", cap_r,
                                         ref_shuffle.PAD_R)
        b = ref_shuffle.shuffle_relation(sk, sp, "shard", cap_s,
                                         ref_shuffle.PAD_S)
        h = ref_skew.detect_heavy_keys(zk, "shard", cases.HEAVY_K,
                                       max(32, cap_z // 8))
        return (*a, *b, h[None])     # each shard's own set, one row

    row = P("shard")
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(row,) * 5,
                           out_specs=(row, row, P(), row, row, P(), row)))
    out = fn(R.key, R.payload, S.key, S.payload, Z.key)
    rk, rp, ovf_r, sk, sp, ovf_s, heavy = (np.asarray(x) for x in out)
    split = lambda a: a.reshape(n, -1)   # noqa: E731
    return (split(rk), split(rp), int(ovf_r), split(sk), split(sp),
            int(ovf_s), heavy)


@pytest.mark.parametrize("world", WORLDS)
def test_shuffle_buffers_equal_the_reference(port, world):
    want = ref_shuffle_and_heavy(world)
    if world == 8:
        assert want[5] > 0    # S overflows: the dropped rows are compared
    for rank, r in enumerate(port(world)):
        got = r["shuffle"]
        for i, w in enumerate(want[:6]):
            if isinstance(w, int):
                assert got[i] == w, (rank, i)
            else:
                np.testing.assert_array_equal(got[i], w[rank],
                                              err_msg=f"rank {rank} [{i}]")


@pytest.mark.parametrize("world", WORLDS)
def test_heavy_keys_equal_the_reference(port, world):
    want = ref_shuffle_and_heavy(world)[6]
    assert (want >= 0).sum() > 0
    for rank, r in enumerate(port(world)):
        np.testing.assert_array_equal(r["heavy"], want[rank],
                                      err_msg=f"rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_shard_relation_gives_the_reference_blocks(port, world):
    R = ref_mesh.shard_relation(jrel("nd1", 0), jmesh(world))
    key, pay = np.asarray(R.key), np.asarray(R.payload)
    rows = key.size // world
    assert key.size == world * -(-(NR - 3) // world)
    for rank, r in enumerate(port(world)):
        cut = slice(rank * rows, (rank + 1) * rows)
        np.testing.assert_array_equal(r["shard"][0], key[cut])
        np.testing.assert_array_equal(r["shard"][1], pay[cut])


def _pack_inputs(n, seed):
    rng = np.random.default_rng(seed)
    key = rng.integers(-3, 1 << 12, n).astype(np.int32)
    key[rng.integers(0, n, n // 10)] = -2       # this side's pad
    pay = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int64).astype(
        np.int32)
    return key, pay


@pytest.mark.parametrize("n_dest,capacity,pad", [(1, 4096, -1),
                                                  (8, 16, -2)])
def test_pack_by_dest_equals_the_reference(n_dest, capacity, pad):
    key, pay = _pack_inputs(3001, n_dest)
    dest = np.random.default_rng(9).integers(0, n_dest, key.size).astype(
        np.int32)
    want = ref_shuffle._pack_by_dest(jnp.asarray(key), jnp.asarray(pay),
                                     jnp.asarray(dest), n_dest, capacity,
                                     np.int32(pad))
    got = shuffle._pack_by_dest(torch.from_numpy(key), torch.from_numpy(pay),
                                torch.from_numpy(dest), n_dest, capacity,
                                pad)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("k", [16])
def test_local_topk_runs_equal_the_reference(k):
    """Many runs of equal length: the lower index wins, as in top_k."""
    rng = np.random.default_rng(k)
    key = np.repeat(rng.permutation(40).astype(np.int32) + 1,
                    rng.integers(1, 6, 40))
    key = np.concatenate([key, np.full(50, -2, np.int32)])
    rng.shuffle(key)
    want = ref_skew._local_topk_runs(jnp.asarray(key), k, np.int32(-2))
    got = skew._local_topk_runs(torch.from_numpy(key), k, -2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("capacity,pad", [(4, -1), (1024, -2)])
def test_split_by_membership_equals_the_reference(capacity, pad):
    key, pay = _pack_inputs(2000, capacity)
    key = np.abs(key) % 64 - (key < 0)          # heavy keys repeat
    heavy = np.sort(np.array([3, 7, 11, 40] + [-2] * 12, np.int32))
    want = ref_skew._split_by_membership(
        jnp.asarray(key), jnp.asarray(pay), jnp.asarray(heavy),
        np.int32(pad), capacity)
    got = skew._split_by_membership(torch.from_numpy(key),
                                    torch.from_numpy(pay),
                                    torch.from_numpy(heavy), pad, capacity)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[4]) == int(want[4])


def test_auto_engine_resolves_by_device():
    assert dj._resolve_engine("auto", "cuda") == "pallas"
    assert dj._resolve_engine("auto", "cpu") == "xla"
    assert dj._resolve_engine("pallas", "cpu") == "pallas"
    with pytest.raises(ValueError, match="unknown engine"):
        dj._resolve_engine("mosaic", "cpu")


# ---------------------------------------------------------------------------
# Bring-up


def test_bringup_noop_without_env(monkeypatch):
    for var in ("AQP_COORDINATOR", "AQP_NUM_PROCS", "AQP_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() == 1
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("how", ["arguments", "environment"])
def test_bringup_single_process_gloo_cluster(how):
    """A one-process group in a process of its own on a port bound at run
    time, from the arguments (spawn_ranks's bring-up; a second call is a
    no-op) or from AQP_COORDINATOR / AQP_NUM_PROCS / AQP_PROC_ID."""
    from aqp_tpu_torch.parallel.bringup import spawn_ranks

    got = spawn_ranks(cases.bringup_cluster, 1, (how,), timeout_s=120)[0]
    k = np.arange(1, 257, dtype=np.int64)
    assert got == (1, 1, "gloo", 1024, int(4 * (4 * k).sum()) % 2**32, 0, 0)


def test_spawn_ranks_reports_a_failed_rank():
    from aqp_tpu_torch.parallel.bringup import spawn_ranks

    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn_ranks(cases.fail_on_rank_one, 2, timeout_s=60)


def test_spawn_ranks_stops_hung_ranks():
    from aqp_tpu_torch.parallel.bringup import spawn_ranks

    with pytest.raises(TimeoutError, match="2 of 2 ranks did not finish"):
        spawn_ranks(cases.hang, 2, timeout_s=2)


# ---------------------------------------------------------------------------
# The weak-scaling study


@pytest.fixture
def reference_matrix(monkeypatch, tmp_path):
    """experiments/weak_scaling.py's (mode, n, nr, ns) matrix over
    conftest's 8 devices: its main with the relations, meshes, joins and
    timing replaced by recorders, run in tmp_path (it writes
    results/weak-scaling.csv there)."""
    import importlib

    import aqp_tpu.utils

    monkeypatch.setattr(aqp_tpu.utils, "ensure_platform_from_env",
                        lambda: None)
    mod = importlib.import_module("experiments.weak_scaling")

    def call(small):
        sizes, rows = [], []

        class Rel:
            def __init__(self, n):
                self.num_tuples, self.key, self.payload = n, None, None

        def fk(ns, nr, seed):
            sizes.append((nr, ns))
            return Rel(ns)

        monkeypatch.setattr(mod, "create_relation_pk",
                            lambda n, seed: Rel(n))
        monkeypatch.setattr(mod, "create_relation_fk", fk)
        monkeypatch.setattr(mod, "make_mesh", lambda n: n)
        monkeypatch.setattr(mod, "shard_relation", lambda rel, mesh: rel)
        monkeypatch.setattr(mod, "make_dist_join_count",
                            lambda *a, **k: None)
        monkeypatch.setattr(mod, "make_dist_join_count_ring",
                            lambda *a, **k: None)
        monkeypatch.setattr(mod, "bench",
                            lambda fn, args, reps: (1.0, sizes[-1][1]))
        monkeypatch.setattr(sys, "argv", ["weak_scaling.py"]
                            + (["--small"] if small else []))
        monkeypatch.chdir(tmp_path)
        mod.main()
        with open(tmp_path / "results" / "weak-scaling.csv") as f:
            lines = f.read().splitlines()
        for line in lines[1:]:
            mode, n, engine = line.split(",")[:3]
            rows.append((mode, int(n), engine))
        return lines[0], rows, sizes

    return call


@pytest.mark.parametrize("small", [False, True], ids=["full", "small"])
def test_weak_scaling_config_equals_the_reference(reference_matrix, small):
    from aqp_tpu_torch.experiments import weak_scaling

    header, rows, sizes = reference_matrix(small)
    assert header == weak_scaling.CSV_HEADER
    got = weak_scaling.configs(small, ranks=len(jax.devices()))
    assert [(m, n) for m, n, _, _ in got] == [(m, n) for m, n, e in rows
                                              if e == "shuffle"]
    assert [(m, n, e) for m, n, e in rows] == [
        (m, n, e) for m, n, _, _ in got for e in weak_scaling.ENGINES]
    assert [(nr, ns) for _, _, nr, ns in got] == sizes


def test_weak_scaling_small_two_ranks_on_the_cpu(tmp_path):
    from aqp_tpu_torch.experiments import weak_scaling

    csv = tmp_path / "ws.csv"
    rows = weak_scaling.main(["--small", "--ranks", "2", "--device", "cpu",
                              "--reps", "1", "--csv", str(csv)])
    want = weak_scaling.configs(True, ranks=2)
    assert len(rows) == 2 * len(want)
    for row, (mode, n, nr, ns) in zip(rows, [c for c in want
                                             for _ in range(2)]):
        assert (row["mode"], row["devices"], row["total_rows"]) == (
            mode, n, nr + ns)
        assert row["matches"] == ns, row
    lines = csv.read_text().splitlines()
    assert lines[0] == weak_scaling.CSV_HEADER and len(lines) == 1 + len(rows)

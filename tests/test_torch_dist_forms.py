"""experiments/dist_forms, the port's counterpart of
__graft_entry__.dryrun_multichip, on 4 gloo ranks at --small, against the
JAX package's shard_map programs (aqp_tpu.parallel) over 4 of conftest's 8
virtual devices on the same numpy inputs; and ops/kernels/held, which holds
each kernel launch to its plain version.

dist_forms checks every form against the exact core on every rank itself
and raises on any mismatch; here its rank-0 rows are held to the
reference's scalars.  Where the reference raises (auto on Zipf z = 1.5 S,
its fixed heavy buffer) or drops keys (rho3's input pads), the rows are
held to the truth computed in numpy."""

import functools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqp_tpu.parallel import dist_join as ref_dj
from aqp_tpu.parallel import mesh as ref_mesh
from aqp_tpu.parallel import skew as ref_skew
from aqp_tpu.relation import Relation as JRelation

from aqp_tpu_torch.experiments import dist_forms
from aqp_tpu_torch.ops.kernels import held, rho3

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_cases as cases  # noqa: E402

RANKS = 4
U32 = 0xFFFFFFFF
STRONG = ("count pallas", "count xla", "2d pallas", "2d xla",
          "materialize", "ring", "skew z=1.5", "auto", "auto z=1.5")
WEAK = ("count pallas", "count xla", "ring")
ARGV = ["--small", "--ranks", str(RANKS), "--device", "cpu", "--reps", "1"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(rank 0's rows by (scaling, form), the CSV the run wrote)."""
    csv = tmp_path_factory.mktemp("dist_forms") / "forms.csv"
    rows = dist_forms.main(ARGV + ["--csv", str(csv)])
    return {(r["scaling"], r["form"]): r for r in rows}, csv


@functools.lru_cache(maxsize=None)
def inputs() -> dict:
    """"r", "s", "z" -> (keys, payloads) as numpy: dist_forms' strong
    relations at --small."""
    rels = dist_forms.relations(*dist_forms.SMALL, "cpu")
    return {name: (rel.key.numpy(), rel.payload.numpy())
            for name, rel in zip("rsz", rels)}


def jrel(name) -> JRelation:
    return JRelation(*(jnp.asarray(c) for c in inputs()[name]))


@functools.lru_cache(maxsize=None)
def jmesh():
    return ref_mesh.make_mesh(RANKS)


def ints(*xs) -> tuple:
    return tuple(int(x) for x in xs)


@functools.lru_cache(maxsize=None)
def reference(form) -> tuple:
    """(matches, checksum, overflow, tier) of the reference's program for
    `form` over 4 virtual devices (its shard-local engine: the XLA core)."""
    r, s = jrel("r"), jrel("s")
    mesh = jmesh()
    if form.startswith("count"):
        m, c, a, b = ref_dj.dist_join_count(r, s, mesh)
        return ints(m, c, a + b) + (None,)
    if form.startswith("2d"):
        m, c, a, b = ref_dj.dist_join_count_2d(r, s,
                                               ref_mesh.make_mesh_2d(2, 2))
        return ints(m, c, a + b) + (None,)
    if form == "materialize":
        m, c, *_, ovf = ref_dj.dist_join_materialize(r, s, mesh)
        return ints(m, c, ovf) + (None,)
    if form == "ring":
        return ints(*ref_dj.dist_join_count_ring(r, s, mesh)) + (0, None)
    if form.startswith("skew z=1.5"):
        # auto's last tier: its heavy threshold, the port's heavy buffer
        # (the form's label carries its rows)
        R = ref_mesh.shard_relation(r, mesh)
        Z = ref_mesh.shard_relation(jrel("z"), mesh)
        fn = ref_skew.make_dist_join_count_skew(
            mesh, R.num_tuples // RANKS, Z.num_tuples // RANKS,
            heavy_threshold=max(32, int(8.0 * Z.num_tuples / R.num_tuples)),
            cap_heavy=int(form.split("cap_heavy=")[1]))
        return ints(*fn(R.key, R.payload, Z.key, Z.payload)) + (None,)
    if form == "auto":
        m, c, tier = ref_dj.dist_join_count_auto(r, s, mesh)
        return m, c, 0, tier
    raise KeyError(form)


def row_scalars(row) -> tuple:
    return row["matches"], row["checksum"], row["overflow"], row["tier"]


@pytest.mark.parametrize("form", [f for f in STRONG if f != "auto z=1.5"])
def test_strong_forms_equal_the_reference(run, form):
    row = run[0]["strong", form]
    want = reference(f"{form} cap_heavy={row['cap_heavy']}"
                     if "cap_heavy" in row else form)
    assert want[0] == 1 << 16 and want[2] == 0
    assert row_scalars(row) == want


def test_skew_tier_sizes_its_heavy_buffer_from_the_heavy_rows(run):
    """The heavy rows a rank holds pass the fixed default of 4,096, and
    the sized buffer stays within a rank's shard of S."""
    cap = run[0]["strong", "skew z=1.5"]["cap_heavy"]
    assert 4096 < cap <= dist_forms.SMALL[1] // RANKS


def test_auto_on_zipf_1_5_answers_the_truth_in_the_skew_tier(run):
    """The reference raises here (its fixed heavy buffer, C11): the truth
    stands in."""
    want = cases.truth_pk(*inputs()["r"], *inputs()["z"])
    assert row_scalars(run[0]["strong", "auto z=1.5"]) == (*want, 0, "skew")


@pytest.mark.parametrize("form", WEAK)
def test_weak_forms_equal_the_reference(run, form):
    """At --small on 4 ranks the weak relations are the strong ones (a
    rank's share times 4, the same seeds)."""
    assert dist_forms.config(True, RANKS)["weak"] == dist_forms.SMALL
    assert row_scalars(run[0]["weak", form]) == reference(form)


def test_materialize_rank_rows_equal_the_reference_shards(run):
    """Each rank's live rows (count and column sums mod 2^32) equal the
    reference's output shard of the same position."""
    _, _, ok, orp, osp, _ = ref_dj.dist_join_materialize(jrel("r"),
                                                         jrel("s"), jmesh())
    ok, orp, osp = (np.asarray(x).astype(np.int64) for x in (ok, orp, osp))
    cap = ok.size // RANKS
    got = run[0]["strong", "materialize"]["rank_live"]
    for rank in range(RANKS):
        cut = slice(rank * cap, (rank + 1) * cap)
        live = ok[cut] != -3
        want = [int(live.sum())] + [int((x[cut][live] & U32).sum()) & U32
                                    for x in (ok, orp, osp)]
        assert got[rank] == want, rank


def pad_truth(wide: bool) -> tuple:
    r, s = dist_forms.pad_key_relations(wide, "cpu")
    rk, rp, sk, sp = (t.numpy() for t in (r.key, r.payload, s.key,
                                          s.payload))
    hit = rk[:, None] == sk[None, :]
    ck = (rp.astype(np.int64)[:, None] & U32) + (sp.astype(np.int64) & U32)
    return int(hit.sum()), int(ck[hit].sum()) & U32


@pytest.mark.parametrize("case", ["pallas", "2d pallas", "auto"])
@pytest.mark.parametrize("label", ["pad keys", "int64"])
def test_pad_key_and_int64_cases(run, label, case):
    """rho3's input pads as real keys: "pallas" reports them as overflow,
    auto (the XLA core on the CPU) answers the truth; int64 relations:
    the truth everywhere."""
    want = pad_truth(label == "int64")
    assert want[0] == 905
    m, c, ovf, tier = row_scalars(run[0]["cases", f"{label} {case}"])
    if label == "pad keys" and case != "auto":
        assert ovf > 0
    else:
        assert (m, c, ovf) == (*want, 0)
        assert tier == ("hash" if case == "auto" else None)


def test_rows_are_timed_and_written(run):
    rows, csv = run
    timed = [r for r in rows.values() if r["scaling"] != "cases"]
    assert len(timed) == len(STRONG) + len(WEAK)
    for r in timed:
        assert len(r["rank_ms"]) == RANKS and r["ms"] == max(r["rank_ms"])
    lines = csv.read_text().splitlines()
    assert lines[0] == dist_forms.CSV_HEADER and len(lines) == 1 + len(rows)


def test_config_holds_the_headline_sizes():
    headline = (13_107_200, 52_428_800)
    assert dist_forms.HEADLINE == headline
    assert dist_forms.config(False, 1) == {"strong": headline}
    assert dist_forms.config(False, 4) == {
        "strong": headline, "weak": (52_428_800, 209_715_200)}
    assert dist_forms.config(True, 4) == {"strong": (1 << 14, 1 << 16),
                                          "weak": (1 << 14, 1 << 16)}
    assert (dist_forms.SEED_R, dist_forms.SEED_S, dist_forms.SEED_Z,
            dist_forms.ZIPF) == (11111, 11112, 22222, 1.5)
    assert [dist_forms.grid_2d(n) for n in (1, 2, 3, 4, 8)] == [
        (1, 1), (2, 1), (1, 3), (2, 2), (2, 4)]


def test_a_broken_rank_makes_main_raise():
    with pytest.raises(RuntimeError, match="rank 1 of 4 failed"):
        dist_forms.main(ARGV, rank_fn=cases.broken_ring_rank)


# ---------------------------------------------------------------------------
# held_to_plain


def small_join():
    rng = np.random.default_rng(22)
    rk = rng.permutation(1 << 12).astype(np.int32) + 1
    sk = rng.integers(1, 1 << 12, 1 << 14).astype(np.int32)
    rp, sp = (rng.integers(-(1 << 31), 1 << 31, k.size).astype(np.int32)
              for k in (rk, sk))
    return tuple(torch.from_numpy(c) for c in (rk, rp, sk, sp))


def test_held_to_plain_records_equal_launches():
    """On CPU tensors every wrapper runs its plain version: held, each
    call equals it, and the wrappers come back."""
    wrappers = {a: getattr(rho3, a) for a in ("k1", "k2", "k3")}
    rec = {}
    with held.held_to_plain(rec):
        m, c, ovf = rho3.rho_join_count_v3(*small_join())
    assert (int(m), int(ovf)) == (1 << 14, 0)
    for k in ("K1", "K2", "K3"):
        assert rec[k]["launches"] == 1 and rec[k]["max_abs_err"] == 0
    assert {a: getattr(rho3, a) for a in wrappers} == wrappers


@pytest.mark.parametrize("attr", ["k1", "k2", "k3"])
def test_held_call_raises_on_a_wrapper_that_differs(monkeypatch, attr):
    """A wrapper whose output differs from its plain version's by one in
    its first element makes the held call raise."""
    wrapper = getattr(rho3, attr)

    def broken(*args, **kw):
        out = list(wrapper(*args, **kw))
        out[0] = out[0].clone()
        out[0].view(-1)[0] += 1
        return tuple(out)

    monkeypatch.setattr(rho3, attr, broken)
    with pytest.raises(held.PlainMismatch, match="differs from its plain"):
        with held.held_to_plain({}):
            rho3.rho_join_count_v3(*small_join())
    assert getattr(rho3, attr) is broken

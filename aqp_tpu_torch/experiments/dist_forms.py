"""Every form of the distributed layer across ranks, each held to the exact
core: the port's counterpart of `__graft_entry__.dryrun_multichip`, at the
headline's width.

One process a rank (parallel.bringup.spawn_ranks): one rank a card under
NCCL, or --ranks gloo processes with --device cpu.  Over a 1-D mesh of
every rank and a 2 x N/2 mesh (1 x N for an odd N):

  strong  bench.py's headline, 13,107,200 dense-PK R against 52,428,800
          FK S, and the same R against Zipf z = 1.5 S, sharded N ways:
          the count join ("pallas": K1, K2, K3 on each rank's receive
          slots; "xla"), the 2-D join (both engines), materialize, the
          ring, the skew tier on z = 1.5 S (auto's last tier, its heavy
          buffer sized as auto sizes it), auto on both S; the pad-key and
          int64 relations through "pallas", the 2-D join and auto;
  weak    the headline a rank (N times its rows in all): the count join
          (both engines) and the ring.  At N = 1 it is the strong run and
          is not repeated.

Every rank holds the whole relations and the exact core's answer over
them (ops/mergejoin), and raises unless each form's scalars equal it with
overflow 0; materialize also as this rank's multiset of live rows against
the exact core's rows whose key the shuffle sends here.  A second pass
holds every kernel launch of the kernel forms to its plain version
(ops/kernels/held).  Then each form is timed: ms a call from CUDA events
(perf_counter on the CPU) after a barrier, the slowest rank's; and the
count "pallas"'s steps on each rank.  Rank 0 prints one JSON line a form
and one summary line; --csv writes the forms' rows (nothing is written
without it).  A failed check on any rank makes the run raise.

    python -m aqp_tpu_torch.experiments.dist_forms [--small] [--reps 3] \\
        [--ranks N] [--csv out.csv] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.data import (
    create_relation_fk, create_relation_pk, create_relation_zipf)
from aqp_tpu_torch.ops import mergejoin
from aqp_tpu_torch.ops.kernels import held as kheld
from aqp_tpu_torch.ops.kernels import rho3
from aqp_tpu_torch.parallel import dist_join as pdj
from aqp_tpu_torch.parallel import shuffle as pshuffle
from aqp_tpu_torch.parallel.bringup import spawn_ranks
from aqp_tpu_torch.parallel.mesh import (
    make_mesh, make_mesh_2d, shard_relation)
from aqp_tpu_torch.relation import Relation
from aqp_tpu_torch.utils.timing import mean_ms

HEADLINE = (13_107_200, 52_428_800)     # bench.py's headline workload
SMALL = (1 << 14, 1 << 16)              # its stand-in at --small
SMALL_WEAK = (1 << 12, 1 << 14)         # a rank's share at --small
SEED_R, SEED_S, SEED_Z = 11111, 11112, 22222   # chip_smoke's draws
ZIPF = 1.5
ENGINES = ("pallas", "xla")
# the forms whose shard-local join is (or, resolved on a card, may be)
# the rho3 pipeline
KERNEL_FORMS = ("count pallas", "2d pallas", "auto", "auto z=1.5")
TIERS = ("hash", "hash+salt", "skew")
CSV_HEADER = "form,scaling,ranks,nr,ns,matches,checksum,overflow,tier,ms"
TIMEOUT_S = 1800.0                  # every rank's whole run, bring-up included
U32 = 0xFFFFFFFF


def config(small: bool = False, ranks: int = 1) -> dict:
    """scaling -> (|R|, |S|) in all: "strong" the headline over every rank;
    "weak" the headline a rank, N times its rows (none at N = 1, where it
    is the strong run)."""
    out = {"strong": SMALL if small else HEADLINE}
    if ranks > 1:
        nr, ns = SMALL_WEAK if small else HEADLINE
        out["weak"] = (nr * ranks, ns * ranks)
    return out


def grid_2d(ranks: int) -> tuple:
    """The 2-D mesh's (hosts, chips a host): 2 x N/2, 1 x N for an odd N."""
    return (2, ranks // 2) if ranks % 2 == 0 else (1, ranks)


def relations(nr: int, ns: int, device, zipf: bool = True) -> tuple:
    """R (dense PK), S (FK) and, with zipf, Zipf z = 1.5 S over R's keys,
    each with random payloads, from the fixed seeds."""
    r = create_relation_pk(nr, seed=SEED_R, random_payload=True,
                           device=device)
    s = create_relation_fk(ns, nr, seed=SEED_S, random_payload=True,
                           device=device)
    z = create_relation_zipf(ns, nr, ZIPF, seed=SEED_Z, random_payload=True,
                             device=device) if zipf else None
    return r, s, z


def pad_key_relations(wide: bool, device) -> tuple:
    """R = {2^30 - 2, 2^30 - 1, 5, 7, 9, 100 ... 399}, S = {2^30 - 2,
    2^30 - 1, 5, 5, 9, 11, 100 ... 399 three times}, seeded payloads: 905
    matches.  The first two keys are rho3's input pads.  wide: int64 keys
    past 2^40, payloads past 32 bits."""
    pads = [rho3.PAD_R_INPUT, rho3.PAD_S_INPUT]
    rk = torch.tensor(pads + [5, 7, 9] + list(range(100, 400)),
                      dtype=torch.int64)
    sk = torch.tensor(pads + [5, 5, 9, 11] + list(range(100, 400)) * 3,
                      dtype=torch.int64)
    gen = torch.Generator().manual_seed(2021)
    bound = 1 << (40 if wide else 31)
    dtype = torch.int64 if wide else torch.int32
    rels = []
    for k in (rk, sk):
        pay = torch.randint(-bound, bound, k.shape, generator=gen,
                            dtype=torch.int64)
        k = k + (1 << 40) if wide else k
        rels.append(Relation(key=k.to(device, dtype),
                             payload=pay.to(device, dtype)))
    return tuple(rels)


def live_rows(key, r_pay, s_pay) -> tuple:
    """The live (key, R payload, S payload) rows of a materialized result
    (unused slots are keyed -3), in one canonical order: equal multisets
    give equal tensors."""
    live = key != -3
    k = key[live].long()
    rp = r_pay[live].long() & U32
    packed = (k << 32) | (s_pay[live].long() & U32)
    order = torch.argsort(rp, stable=True)
    order = order[torch.argsort(packed[order], stable=True)]
    return packed[order], rp[order]


def _fail(rank: int, what: str) -> None:
    raise RuntimeError(f"dist_forms rank {rank}: {what}")


def scalars(out) -> tuple:
    """(matches, checksum, overflow, tier) of a form's output: auto's
    (matches, checksum, tier), or the join's 0-dim tensors (its overflows
    summed) beside this rank's columns."""
    vals = [x if isinstance(x, str) else int(x) for x in out
            if not (isinstance(x, torch.Tensor) and x.dim() > 0)]
    tier = vals.pop() if isinstance(vals[-1], str) else None
    return vals[0], vals[1], sum(vals[2:]), tier


def _gather(values) -> list:
    """Every rank's float values, in rank order (rank -> list): through the
    group's CPU backend (gloo), on a card too."""
    t = torch.tensor(values, dtype=torch.float64)
    out = t.new_empty(dist.get_world_size() * t.numel())
    dist.all_gather_into_tensor(out, t)
    return out.view(dist.get_world_size(), -1).tolist()


def rank_ms(fn, dev, reps: int) -> list:
    """Each rank's ms a call (utils/timing.mean_ms: one warm-up call, then
    CUDA events around `reps` calls on a card, perf_counter on the CPU),
    every rank starting after a barrier; in rank order."""
    dist.barrier()
    ms, _ = mean_ms(fn, dev, reps)
    return [r[0] for r in _gather([ms])]


def strong_forms(r, s, z, mesh, mesh2) -> tuple:
    """(label -> the form's call on this rank's shards of r, s and z; the
    skew tier's heavy buffer rows)."""
    R, S, Z = (shard_relation(x, mesh) for x in (r, s, z))
    R2, S2 = (shard_relation(x, mesh2) for x in (r, s))
    count = {e: pdj.make_dist_join_count(mesh, R.num_tuples, S.num_tuples,
                                         engine=e) for e in ENGINES}
    count2 = {e: pdj.make_dist_join_count_2d(mesh2, R2.num_tuples,
                                             S2.num_tuples, engine=e)
              for e in ENGINES}
    mat = pdj.make_dist_join_materialize(mesh, R.num_tuples, S.num_tuples)
    ring = pdj.make_dist_join_count_ring(mesh)
    skew, cap_heavy = pdj.make_skew_tier(mesh, R, Z)
    rs = (R.key, R.payload, S.key, S.payload)
    rs2 = (R2.key, R2.payload, S2.key, S2.payload)
    return {
        **{f"count {e}": (lambda f=count[e]: f(*rs)) for e in ENGINES},
        **{f"2d {e}": (lambda f=count2[e]: f(*rs2)) for e in ENGINES},
        "materialize": lambda: mat(*rs),
        "ring": lambda: ring(*rs),
        "skew z=1.5": lambda: skew(R.key, R.payload, Z.key, Z.payload),
        "auto": lambda: pdj.dist_join_count_auto(r, s, mesh),
        "auto z=1.5": lambda: pdj.dist_join_count_auto(r, z, mesh),
    }, cap_heavy


def weak_forms(r, s, mesh) -> dict:
    """label -> the count join (both engines) or the ring on this rank's
    shards of r and s."""
    R, S = (shard_relation(x, mesh) for x in (r, s))
    count = {e: pdj.make_dist_join_count(mesh, R.num_tuples, S.num_tuples,
                                         engine=e) for e in ENGINES}
    ring = pdj.make_dist_join_count_ring(mesh)
    rs = (R.key, R.payload, S.key, S.payload)
    return {**{f"count {e}": (lambda f=count[e]: f(*rs)) for e in ENGINES},
            "ring": lambda: ring(*rs)}


def exact(r, s) -> tuple:
    ex = mergejoin.merge_join_count(r.key, r.payload, s.key, s.payload)
    return int(ex.matches), int(ex.checksum)


def check_materialize(out, r, s, rank: int, n: int) -> list:
    """This rank's live rows against the exact core's rows whose key the
    shuffle sends to it (shuffle.destination at salt 0), as multisets;
    returns every rank's (live rows, sums of key, R and S payloads mod
    2^32)."""
    want = mergejoin.merge_join_materialize(r.key, r.payload, s.key,
                                            s.payload, s.num_tuples)
    mine = (want.key != -3) & (pshuffle.destination(want.key, n) == rank)
    want = live_rows(want.key[mine], want.r_payload[mine],
                     want.s_payload[mine])
    got = live_rows(*out[2:5])
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        _fail(rank, f"materialize: {got[0].numel()} live rows differ from "
              f"the exact core's {want[0].numel()} routed to this rank")
    packed, rp = got
    digest = [packed.numel(), int((packed >> 32).sum()) & U32,
              int(rp.sum()) & U32, int((packed & U32).sum()) & U32]
    return [[int(v) for v in row] for row in _gather(digest)]


def pad_key_cases(mesh, mesh2, device) -> dict:
    """label -> (scalars, the truth): real keys equal to rho3's input pads
    and int64 relations through "pallas" (1-D and 2-D) and auto.  Where
    the pads meet "pallas" its overflow is reported; auto answers the
    truth, past a reported overflow where auto resolves to "pallas"."""
    out = {}
    for label, wide in (("pad keys", False), ("int64", True)):
        r, s = pad_key_relations(wide, device)
        want = exact(r, s)
        R, S = shard_relation(r, mesh), shard_relation(s, mesh)
        R2, S2 = shard_relation(r, mesh2), shard_relation(s, mesh2)
        one = pdj.make_dist_join_count(mesh, R.num_tuples, S.num_tuples,
                                       engine="pallas")
        two = pdj.make_dist_join_count_2d(mesh2, R2.num_tuples,
                                          S2.num_tuples, engine="pallas")
        out[f"{label} pallas"] = (scalars(one(R.key, R.payload, S.key,
                                                S.payload)), want)
        out[f"{label} 2d pallas"] = (scalars(two(R2.key, R2.payload, S2.key,
                                                   S2.payload)), want)
        out[f"{label} auto"] = (scalars(pdj.dist_join_count_auto(r, s,
                                                                 mesh)),
                                want)
    return out


def check_pad_key_cases(cases, rank: int, engine: str) -> None:
    """The pad keys: "pallas" reports the overflow (never a short count
    with overflow 0), auto answers the truth ("hash+salt" past the
    reported overflow where auto is "pallas"); int64: the truth, overflow
    0, tier "hash"."""
    for label, ((m, c, ovf, tier), want) in cases.items():
        if label.startswith("pad keys") and label.endswith("pallas"):
            ok = ovf > 0
        elif label.endswith("auto"):
            wide = label.startswith("int64")
            ok = (m, c) == want and tier == (
                "hash+salt" if engine == "pallas" and not wide else "hash")
        else:
            ok = (m, c, ovf) == want + (0,)
        if not ok:
            _fail(rank, f"{label}: {(m, c, ovf, tier)}, the exact core "
                  f"{want}")


def held_pass(forms, labels, rank: int, card: bool) -> dict:
    """The kernel forms once more with every launch held to its plain
    version (held.held_to_plain); on a card every launch of the pass must
    be a held one.  Returns per kernel its held launches, max_abs_err and
    input shapes."""
    held = {}
    kheld.reset_launches()
    with kheld.held_to_plain(held):
        for label in labels:
            forms[label]()
    rose = {k: v for k, v in kheld.read_launches().items() if v}
    if card and rose != {k: v["launches"] for k, v in held.items()}:
        _fail(rank, f"a launch escaped the plain check: launched {rose}, "
              f"held {held}")
    if not all(held.get(k, {}).get("launches") for k in ("K1", "K2", "K3")):
        _fail(rank, f"K1, K2 or K3 not held: {held}")
    return held


def count_steps(R, S, mesh, dev, reps: int) -> dict:
    """Each rank's ms of the count "pallas"'s steps: each side's pack
    (_pack_send_buffers), its keys' and payloads' all_to_all_single alone,
    and the local count on the receive slots."""
    group = mesh.get_group("shard")
    n = dist.get_world_size(group)
    ms, recv = {}, []
    for side, X, pad in (("R", R, pshuffle.PAD_R), ("S", S, pshuffle.PAD_S)):
        cap = pdj._capacity(X.num_tuples, n, 2.0)
        bk, bp, _ = pshuffle._pack_send_buffers(X.key, X.payload, n, cap,
                                                pad, 0)
        ms[f"pack {side}"] = rank_ms(
            lambda X=X, cap=cap, pad=pad: pshuffle._pack_send_buffers(
                X.key, X.payload, n, cap, pad, 0), dev, reps)
        ms[f"all_to_all {side}"] = rank_ms(
            lambda bk=bk, bp=bp: (pshuffle._exchange(bk, group),
                                  pshuffle._exchange(bp, group)),
            dev, reps)
        recv += [pshuffle._exchange(bk, group), pshuffle._exchange(bp, group)]
    ms["local count"] = rank_ms(lambda: pdj._local_count(*recv, "pallas"),
                                dev, reps)
    return ms


def run_block(scaling, sizes, forms, truth, rank, n, dev, reps,
              more=None) -> tuple:
    """One scaling's forms on relations of `sizes` rows: the main pass
    (each form checked against `truth`, then more(out, rows), which may
    check and call more), the held pass, the timing.  Returns (rows by
    form, held, the main pass's launches)."""
    card = dev.type == "cuda"
    kheld.reset_launches()
    out = {label: fn() for label, fn in forms.items()}
    rows = {}
    for label, res in out.items():
        m, c, ovf, tier = scalars(res)
        want = truth["z" if "z=1.5" in label else "s"]
        if (m, c) != want or ovf != 0 or (
                label.startswith("auto") and tier not in TIERS):
            _fail(rank, f"{scaling} {label}: {(m, c, ovf, tier)}, the exact "
                  f"core {want}")
        rows[label] = {"form": label, "scaling": scaling, "ranks": n,
                       "nr": sizes[0], "ns": sizes[1], "matches": m,
                       "checksum": c, "overflow": ovf, "tier": tier,
                       "want": list(want)}
    if more is not None:
        more(out, rows)
    del out
    if card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    launches = kheld.read_launches()
    held = held_pass(forms, [k for k in KERNEL_FORMS if k in forms], rank,
                     card)
    for label, fn in forms.items():
        per = rank_ms(fn, dev, reps)
        rows[label].update(ms=max(per), rank_ms=per)
    return rows, held, launches


def run_rank(rank: int, world: int, small: bool, reps: int,
             device: str) -> list:
    """Every form on this rank; rank 0 prints the lines and returns the
    forms' rows (the other ranks return [])."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    card = dev.type == "cuda"
    if card:
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)
    engine = pdj._resolve_engine("auto", dev.type)
    mesh = make_mesh(world, device=dev.type)
    mesh2 = make_mesh_2d(*grid_2d(world), device=dev.type)
    cfg = config(small, world)
    say = print if rank == 0 else (lambda *a, **k: None)
    if rank == 0 and card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        say(smi.stdout.strip(), flush=True)
    rows, held, launches, steps = [], {}, {}, {}

    nr, ns = cfg["strong"]
    r, s, z = relations(nr, ns, dev)
    truth = {"s": exact(r, s), "z": exact(r, z)}
    pads = {}

    def strong_more(out, rows_):
        # materialize's rows on this rank; then the pad-key and int64 cases
        rows_["materialize"]["rank_live"] = check_materialize(
            out["materialize"], r, s, rank, world)
        pads.update(pad_key_cases(mesh, mesh2, dev))
        check_pad_key_cases(pads, rank, engine)

    forms, cap_heavy = strong_forms(r, s, z, mesh, mesh2)
    got, held["strong"], launches["strong"] = run_block(
        "strong", (nr, ns), forms, truth, rank, world, dev, reps,
        strong_more)
    got["skew z=1.5"]["cap_heavy"] = cap_heavy
    del forms
    R, S = shard_relation(r, mesh), shard_relation(s, mesh)
    steps["strong"] = count_steps(R, S, mesh, dev, reps)
    rows += list(got.values())
    rows += [{"form": label, "scaling": "cases", "ranks": world,
              "nr": 303, "ns": 1207, "matches": m, "checksum": c,
              "overflow": ovf, "tier": tier, "want": list(want)}
             for label, ((m, c, ovf, tier), want) in pads.items()]
    del r, s, z, R, S
    if card:
        torch.cuda.empty_cache()

    if "weak" in cfg:
        nr, ns = cfg["weak"]
        r, s, _ = relations(nr, ns, dev, zipf=False)
        truth = {"s": exact(r, s)}
        got, held["weak"], launches["weak"] = run_block(
            "weak", (nr, ns), weak_forms(r, s, mesh), truth, rank, world,
            dev, reps)
        R, S = shard_relation(r, mesh), shard_relation(s, mesh)
        steps["weak"] = count_steps(R, S, mesh, dev, reps)
        rows += list(got.values())
        del r, s, R, S

    kernels = ("K1", "K2", "K3")
    main = {k: sum(v[k] for v in launches.values()) for k in kernels}
    if card and not all(main.values()):
        _fail(rank, f"K1, K2 or K3 not launched on the main path: {main}")
    per_rank = {
        "launches": _gather([main[k] for k in kernels]),
        "held": _gather([sum(h.get(k, {}).get("launches", 0)
                             for h in held.values()) for k in kernels]),
        "max_abs_err": _gather([max((h.get(k, {}).get("max_abs_err", 0)
                                     for h in held.values()), default=0)
                                for k in kernels]),
        "peak_bytes": _gather([torch.cuda.max_memory_allocated(dev)
                               if card else -1]),
        "seconds": _gather([time.perf_counter() - t0])}
    for row in rows:
        say(json.dumps({"dist_form": row}), flush=True)
    say(json.dumps({"dist_forms": {
        "ranks": world, "device": (torch.cuda.get_device_name(dev) if card
                                   else "cpu"),
        "backend": dist.get_backend(), "engine": engine,
        "kernels": list(kernels),
        **{k: [[int(x) for x in v] for v in vals]
           for k, vals in per_rank.items() if k != "seconds"},
        # device memory is not measured on the CPU
        **({} if card else {"peak_bytes": None}),
        "seconds": [v[0] for v in per_rank["seconds"]],
        "held_inputs": {sc: {k: v["inputs"] for k, v in h.items()}
                        for sc, h in held.items()},
        "steps": steps}}), flush=True)
    return rows if rank == 0 else []


def main(argv: Optional[List[str]] = None, rank_fn=None) -> list:
    """Parse the flags and run `rank_fn` (default run_rank) on every rank;
    returns rank 0's rows.  Raises where any rank's check failed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes, one a rank (default: every card; 1 "
                         "on the CPU)")
    ap.add_argument("--csv", default=None,
                    help="write the rows here (nothing is written without)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ranks = args.ranks or (torch.cuda.device_count() if dev.type == "cuda"
                           else 1)
    rows = spawn_ranks(rank_fn or run_rank, ranks,
                       (args.small, args.reps, dev.type),
                       timeout_s=TIMEOUT_S)[0]
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(CSV_HEADER + "\n")
            for r in rows:
                f.write(",".join("" if r.get(c) is None else str(r[c])
                                 for c in CSV_HEADER.split(",")) + "\n")
        print(f"wrote {args.csv} ({len(rows)} rows, device {dev.type})",
              flush=True)
    return rows


if __name__ == "__main__":
    main()

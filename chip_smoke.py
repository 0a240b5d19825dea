"""Smoke run of the PyTorch/CUDA port (aqp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on one line with its elapsed seconds:
  1. device: a CUDA card is required; its name and power limit are printed
     as nvidia-smi reports them;
  2. build: every kernel is compiled from aqp_tpu_torch/csrc by one nvcc
     call (no PyTorch headers, no ninja, no network);
  3. kernels: K1, K2 and K3 against their plain PyTorch versions on the
     card, at the default and at a small geometry, keys-only and with
     payloads: exact equality;
  4. the slice at full width: run_join("RHO") keys-only and checksummed and
     engine.rho_join_count_fused on |R| = 13,107,200 dense PK keys and
     |S| = 52,428,800 tiled FK keys with seeded random payloads (bench.py's
     workload); matches must equal |S|, the checksum must equal the exact
     core's, and every kernel must have been launched; then ms per call;
  5. each kernel at the shapes of phase 4: time, plain version's time,
     bound, and exact agreement;
  6. the ladder: a duplicate-heavy S overflows every salt and must get the
     exact core's answer.
Then one JSON line with the kernels' numbers, and last the result line
{"ok": true, "device": {...}}.  Any failure exits non-zero; a watchdog
ends a run that hangs.
"""

import faulthandler

faulthandler.dump_traceback_later(420, exit=True)

import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from aqp_tpu_torch.config import JoinConfig  # noqa: E402
from aqp_tpu_torch.data import create_relation_fk, create_relation_pk  # noqa: E402
from aqp_tpu_torch import engine  # noqa: E402
from aqp_tpu_torch.joins.api import run_join  # noqa: E402
from aqp_tpu_torch.ops import mergejoin  # noqa: E402
from aqp_tpu_torch.ops.kernels import build, rho3  # noqa: E402
from aqp_tpu_torch.relation import Relation  # noqa: E402

NR, NS = 13_107_200, 52_428_800      # bench.py's headline workload
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
REPS = 5
T0 = time.perf_counter()
SOURCE = "aqp_tpu_torch/csrc/rho3.cu"
REPLACES = {"K1": "aqp_tpu/ops/pallas/rho3.py:212",
            "K2": "aqp_tpu/ops/pallas/rho3.py:250",
            "K3": "aqp_tpu/ops/pallas/rho3.py:300"}
SMALL_GEOM = rho3.Rho3Params(block_rows=128, slot_rows=8, f1=20, f2=4,
                             kd_slot_rows=16)


def say(msg: str) -> None:
    print(f"[smoke {time.perf_counter() - T0:7.2f}s] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call over `reps` calls after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(got, want) -> int:
    """Largest |got - want| over matching outputs (None must meet None)."""
    err = 0
    for g, w in zip(got, want):
        if g is None or w is None:
            require(g is None and w is None, "an output is missing")
            continue
        require(tuple(g.shape) == tuple(w.shape),
                f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        d = (g.long() - w.long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def stage_inputs(rk, rp, sk, sp, prm, with_payload):
    """The inputs the main path hands K1, K2 and K3, from the kernels."""
    key = torch.cat([rk, sk])
    tag = torch.cat([torch.zeros_like(rk), torch.ones_like(sk)])
    packed, alias = rho3.pack_keys(key, tag, rho3.HASH_C)
    pay = torch.cat([rp, sp]) if with_payload else None
    nb = rho3.num_blocks(packed.numel(), prm)
    scale = rho3.default_scale(prm)
    k1_in = (packed, pay, nb, prm, scale)
    k1_out = rho3.k1(*k1_in)
    k2_in = (k1_out[0], k1_out[1], k1_out[2], prm, scale)
    k2_out = rho3.k2(*k2_in)
    k3_in = (k2_out[0], k2_out[1], k2_out[2])
    return int(alias), {"K1": (k1_in, k1_out), "K2": (k2_in, k2_out),
                        "K3": (k3_in, None)}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def kernel_bytes(name, args, out) -> int:
    """Bytes the kernel's function must move: each input read once (only
    the real slot elements, which the counts delimit), each output written
    once."""
    if name == "K1":
        packed, pay = args[0], args[1]
        return nbytes(packed, pay) + nbytes(*out[:3]) + 8
    if name == "K2":
        k1k, k1p, cnt1 = args[:3]
        real = int(cnt1.sum()) * 4 * (2 if k1p is not None else 1)
        return real + nbytes(cnt1) + nbytes(*out[:3]) + 8
    k2k, k2p, cnt2 = args
    real = int(cnt2.sum()) * 4 * (2 if k2p is not None else 1)
    return real + nbytes(cnt2) + 16


PLAIN = {"K1": rho3.k1_plain, "K2": rho3.k2_plain, "K3": rho3.k3_plain}
KERNEL = {"K1": rho3.k1, "K2": rho3.k2, "K3": rho3.k3}


def check_kernels(rk, rp, sk, sp, prm, with_payload) -> None:
    """Each kernel equals its plain version exactly on the same inputs."""
    alias, stages = stage_inputs(rk, rp, sk, sp, prm, with_payload)
    require(alias == 0, "pack_keys reported an alias")
    for name in ("K1", "K2", "K3"):
        args, _ = stages[name]
        got = KERNEL[name](*args)
        want = PLAIN[name](*args)
        torch.cuda.synchronize()
        if name != "K3":
            require(int(got[3]) == 0, f"{name} overflowed")
        err = max_abs_err(got, want)
        require(err == 0, f"{name} differs from its plain version by {err}"
                f" ({prm}, payload={with_payload})")


def seeded(nr, ns, seed):
    r = create_relation_pk(nr, seed=seed, random_payload=True)
    s = create_relation_fk(ns, nr, seed=seed + 1, random_payload=True)
    return r, s


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: no answer"
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    say(f"device: {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    # 2. build
    _, secs = build.build()
    build.load()
    say(f"build: {secs:.2f} s of nvcc")

    # 3. kernels against their plain versions, moderate sizes
    # (the small geometry's slots only hold a small input)
    for prm, nr in ((rho3.Rho3Params(), 1 << 20), (SMALL_GEOM, 1 << 14)):
        r, s = seeded(nr, 4 * nr, seed=101)
        for with_payload in (False, True):
            check_kernels(r.key, r.payload, s.key, s.payload, prm,
                          with_payload)
    # duplicate R keys: K3's rule for which R copy answers must agree too
    gen = torch.Generator(device="cuda").manual_seed(202)
    rk, sk = (torch.randint(1, 1 << 19, (n,), generator=gen, device="cuda",
                            dtype=torch.int32) for n in (1 << 20, 4 << 20))
    rp, sp = (torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen,
                            device="cuda", dtype=torch.int64).int()
              for n in (1 << 20, 4 << 20))
    for with_payload in (False, True):
        check_kernels(rk, rp, sk, sp, rho3.Rho3Params(), with_payload)
    say("kernels: K1, K2, K3 equal their plain versions (default and "
        "small geometry, unique and duplicate R keys, keys-only and with "
        "payloads)")

    # a small input against a plain dictionary-free numpy oracle
    rs, ss = seeded(4096, 16384, seed=7)
    res, _ = run_join(rs, ss, "RHO", JoinConfig(dense_path=False))
    rk, rp = rs.key.cpu().numpy(), rs.payload.cpu().numpy()
    sk, sp = ss.key.cpu().numpy(), ss.payload.cpu().numpy()
    order = np.argsort(rk)
    at = np.searchsorted(rk[order], sk)
    want_c = int((rp[order][at].astype(np.int64) & 0xFFFFFFFF).sum()
                 + (sp.astype(np.int64) & 0xFFFFFFFF).sum()) & 0xFFFFFFFF
    require(int(res.matches) == 16384 and int(res.checksum) == want_c,
            "small RHO join disagrees with the numpy oracle")
    del r, s, rs, ss

    # 4. the slice at full width
    relR, relS = seeded(NR, NS, seed=11111)
    torch.cuda.synchronize()
    say(f"data: |R| = {NR}, |S| = {NS} on the card")
    for k in rho3.LAUNCHES:
        rho3.LAUNCHES[k] = 0
    keys_res, _ = run_join(relR, relS, "RHO", JoinConfig(checksum=False))
    sum_res, _ = run_join(relR, relS, "RHO", JoinConfig())
    fm, fc, fovf = engine.rho_join_count_fused(relR.key, relR.payload,
                                               relS.key, relS.payload)
    torch.cuda.synchronize()
    launches = dict(rho3.LAUNCHES)
    say(f"main path launches: {launches}")
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched on the main path: {launches}")
    exact = mergejoin.merge_join_count(relR.key, relR.payload, relS.key,
                                       relS.payload)
    require(int(exact.matches) == NS, "exact core: matches != |S|")
    require(int(keys_res.matches) == NS, "keys-only RHO: matches != |S|")
    require(int(keys_res.checksum) == 0, "keys-only RHO: checksum != 0")
    require(int(sum_res.matches) == NS, "RHO: matches != |S|")
    require(int(sum_res.checksum) == int(exact.checksum),
            "RHO: checksum != exact core")
    require(int(fovf) == 0, "fused: overflow")
    require((int(fm), int(fc)) == (NS, int(exact.checksum)),
            "fused: result != exact core")
    say(f"slice: matches = {NS}, checksum = {int(exact.checksum)} "
        "(= exact core), overflow 0")
    slice_ms = {}
    for label, cfg in (("keys-only", JoinConfig(checksum=False)),
                       ("checksummed", JoinConfig())):
        ms = cuda_ms(lambda: run_join(relR, relS, "RHO", cfg), REPS)
        slice_ms[label] = ms
        say(f"run_join RHO {label}: {ms:.3f} ms/call, "
            f"{(NR + NS) / ms / 1e3:.1f} M rows/s")
    ms = cuda_ms(lambda: engine.rho_join_count_fused(
        relR.key, relR.payload, relS.key, relS.payload), REPS)
    say(f"engine.rho_join_count_fused: {ms:.3f} ms/call, "
        f"{(NR + NS) / ms / 1e3:.1f} M rows/s")

    def pack():
        key = torch.cat([relR.key, relS.key])
        tag = torch.cat([torch.zeros_like(relR.key),
                         torch.ones_like(relS.key)])
        return rho3.pack_keys(key, tag, rho3.HASH_C)

    pack_ms = cuda_ms(pack, REPS)
    say(f"pack_keys (plain PyTorch, before K1): {pack_ms:.3f} ms/call")
    print(json.dumps({"slice": {k: {"ms": v, "mrows_per_s":
                                    (NR + NS) / v / 1e3}
                                for k, v in slice_ms.items()},
                      "fused_ms": ms, "pack_ms": pack_ms}), flush=True)

    # 5. each kernel at the main path's shapes
    rows = []
    for with_payload in (False, True):
        _, stages = stage_inputs(relR.key, relR.payload, relS.key,
                                 relS.payload, rho3.Rho3Params(),
                                 with_payload)
        for name in ("K1", "K2", "K3"):
            args, _ = stages[name]
            out = KERNEL[name](*args)
            want = PLAIN[name](*args)
            torch.cuda.synchronize()
            err = max_abs_err(out, want)
            require(err == 0, f"{name} differs from its plain version at "
                    f"the headline shape (payload={with_payload})")
            del want
            k_ms = cuda_ms(lambda: KERNEL[name](*args), REPS)
            p_ms = cuda_ms(lambda: PLAIN[name](*args), 1)
            bound = kernel_bytes(name, args, out) / HBM_BYTES_PER_S * 1e3
            row = {"name": name, "route": "cuda", "source": SOURCE,
                   "replaces": REPLACES[name],
                   "launches": launches[name], "max_abs_err": err,
                   "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                   "bound_by": "bytes", "library_ms": None}
            say(f"{name} {'payload' if with_payload else 'keys-only'}: "
                f"{k_ms:.3f} ms (plain {p_ms:.3f} ms, bound {bound:.3f} "
                "ms)")
            if with_payload:
                print(json.dumps({"with_payload": row}), flush=True)
            else:
                rows.append(row)
        del stages
        torch.cuda.synchronize()

    # 6. the ladder: one key on a quarter of S overflows every salt
    rl, sl = seeded(1 << 20, 4 << 20, seed=303)
    skey = sl.key.clone()
    skey[: skey.numel() // 4] = 77
    sl = Relation(key=skey, payload=sl.payload)
    for salt in rho3.RETRY_SALTS:
        _, _, ovf = rho3.rho_join_count_v3(rl.key, rl.payload, sl.key,
                                           sl.payload, salt=salt)
        require(int(ovf) > 0, "the duplicate-heavy input did not overflow")
    for k in rho3.LAUNCHES:
        rho3.LAUNCHES[k] = 0
    res, _ = run_join(rl, sl, "RHO", JoinConfig(dense_path=False))
    exact = mergejoin.merge_join_count(rl.key, rl.payload, sl.key,
                                       sl.payload)
    require(rho3.LAUNCHES["K1"] == len(rho3.RETRY_SALTS),
            f"the ladder did not try every salt: {rho3.LAUNCHES}")
    require((int(res.matches), int(res.checksum))
            == (int(exact.matches), int(exact.checksum))
            and int(res.matches) == sl.num_tuples,
            "the ladder's answer != exact core")
    say("ladder: every salt overflowed, the exact core answered")

    torch.cuda.synchronize()
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

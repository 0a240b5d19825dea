"""Roofline accounting of the headline RHO count join, keys-only
(counterpart of experiments/roofline.py).

Times the reference's three stages at the headline workload, each the mean
of 6 calls after a warm-up (CUDA events on the card): the partition
(_partition_2level: pack_keys, K1, K2), the whole count
(rho_join_count_v3, keys-only; K3 = the count less the partition) and the
checksummed count; and each kernel alone on the inputs the pipeline gives
it.  A kernel's device-memory bytes are counted from this port's tensors
at its geometry: numel x element size of each input and each output of K1
(packed keys -> slots, counts, overflow), K2 (slots, counts -> fine slots,
counts, overflow) and K3 (fine slots, counts -> matches, checksum).  The
partition's bytes are K1's and K2's (pack_keys's own traffic is not
counted, as in the reference).  The peak is the H100 SXM data sheet's
3.35 TB/s, a published figure, not a measurement; the card's name and
power limit are printed beside the table as nvidia-smi reports them.

    python -m aqp_tpu_torch.experiments.roofline [--small] \\
        [--out roofline.md] [--device cuda|cpu]

13,107,200 PK x 52,428,800 FK keys (2^16 x 2^18 with --small), seeds
11111 and 22222.  The card is the default; --device cpu runs the kernels'
plain versions.  Nothing is written without --out.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.data import create_relation_fk, create_relation_pk
from aqp_tpu_torch.ops.kernels import rho3
from aqp_tpu_torch.ops.kernels.rho3 import (HASH_C, Rho3Params,
                                            _partition_2level,
                                            rho_join_count_v3)
from aqp_tpu_torch.utils.timing import mean_ms

SIZES = {False: (13_107_200, 52_428_800), True: (1 << 16, 1 << 18)}
SEEDS = (11111, 22222)
REPS = 6
PEAK_GBS = 3350.0        # H100 SXM data sheet: HBM3 at 3.35 TB/s
TABLE_HEADER = ("| stage | HBM GB moved | seconds | achieved GB/s | % of "
                f"{PEAK_GBS:.0f} GB/s peak |")


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    if dev.type != "cuda":
        return "cpu (no card: the kernels' plain versions ran)"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", "-i", str(idx),
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi exited {out.returncode}: "
                           f"{out.stderr.strip()}")
    return out.stdout.strip()


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def kernel_inputs(rk, sk, prm: Rho3Params) -> dict:
    """The keys-only pipeline's kernel calls on R and S: name -> (call,
    its input tensors, its output tensors), each call made once here."""
    packed, _ = rho3.pack_pair(rk, sk, HASH_C)
    nb = rho3.num_blocks(packed.numel(), prm)
    scale = rho3.default_scale(prm)
    k1k, _, cnt1, ovf1 = rho3.k1(packed, None, nb, prm, scale)
    k2k, _, cnt2, ovf2 = rho3.k2(k1k, None, cnt1, prm, scale)
    m, c = rho3.k3(k2k, None, cnt2)
    return {
        "K1": (lambda: rho3.k1(packed, None, nb, prm, scale), (packed,),
               (k1k, cnt1, ovf1)),
        "K2": (lambda: rho3.k2(k1k, None, cnt1, prm, scale), (k1k, cnt1),
               (k2k, cnt2, ovf2)),
        "K3": (lambda: rho3.k3(k2k, None, cnt2), (k2k, cnt2), (m, c)),
    }


def kernel_bytes(calls: dict) -> dict:
    """Per kernel, the bytes of its input and output tensors."""
    return {k: _nbytes(*ins, *outs) for k, (_, ins, outs) in calls.items()}


def _row(label, gb, secs) -> str:
    rate = gb / secs
    return (f"| {label} | {gb:.3f} | {secs:.6f} | {rate:.1f} | "
            f"{rate / PEAK_GBS * 100:.1f}% |")


def main(argv=None) -> dict:
    """Measure and print the table; returns {"stages": {label: (GB,
    seconds)}, "kernels": {name: (GB, seconds)}, "checksummed_s",
    "matches", "card", "lines"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=None,
                    help="write the markdown here (nothing is written "
                         "without)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    card = card_line(dev)
    nr, ns = SIZES[args.small]
    prm = Rho3Params()
    relR = create_relation_pk(nr, seed=SEEDS[0], device=dev)
    relS = create_relation_fk(ns, nr, seed=SEEDS[1], device=dev)
    rk, rp, sk, sp = relR.key, relR.payload, relS.key, relS.payload

    def secs(fn):
        return mean_ms(fn, dev, REPS)[0] / 1e3

    t_part = secs(lambda: _partition_2level(rk, rp, sk, sp, prm, HASH_C,
                                            False, None)[0])
    t_full, (m, _, ovf) = mean_ms(lambda: rho_join_count_v3(
        rk, rp, sk, sp, prm, with_checksum=False), dev, REPS)
    t_full /= 1e3
    t_ck = secs(lambda: rho_join_count_v3(rk, rp, sk, sp, prm,
                                          with_checksum=True))
    t_k3 = max(1e-9, t_full - t_part)
    if int(ovf):
        raise RuntimeError(f"the pipeline overflowed ({int(ovf)}) on an FK "
                           "workload")
    calls = kernel_inputs(rk, sk, prm)
    gb = {k: v / 1e9 for k, v in kernel_bytes(calls).items()}
    kernels = {k: (gb[k], secs(fn)) for k, (fn, _, _) in calls.items()}
    stages = {"K1+K2 (partition)": (gb["K1"] + gb["K2"], t_part),
              "K3 (join)": (gb["K3"], t_k3),
              "total": (sum(gb.values()), t_full)}
    labels = {"K1": "K1 (block sort + slot emit)",
              "K2": "K2 (region merge + fine emit)",
              "K3": "K3 (merge + propagate join)"}

    lines = [
        "# Roofline accounting — headline RHO count join (keys-only)",
        "",
        f"Workload: {nr / 1e6:.1f}M x {ns / 1e6:.1f}M (int32 keys); "
        f"geometry: block {prm.block_rows}x128, f1={prm.f1}, f2={prm.f2}, "
        f"slots {prm.cap1} and {prm.cap2} elements.",
        f"Card: {card}.  Peak: {PEAK_GBS:.0f} GB/s, the H100 SXM data "
        "sheet's HBM3 rate (published, not measured).",
        "Bytes: numel x element size of each kernel's input and output "
        "tensors (the partition's: K1's and K2's; its time includes "
        "pack_keys).",
        "",
        TABLE_HEADER,
        "|---|---|---|---|---|",
        *(_row(k, g, s) for k, (g, s) in stages.items()),
        "",
        TABLE_HEADER.replace("| stage |", "| kernel alone |"),
        "|---|---|---|---|---|",
        *(_row(labels[k], g, s) for k, (g, s) in kernels.items()),
        "",
        f"Checksummed count: {t_ck:.6f} s.",
    ]
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
        print(f"wrote {args.out}")
    return {"stages": stages, "kernels": kernels, "checksummed_s": t_ck,
            "matches": int(m), "card": card, "lines": lines}


if __name__ == "__main__":
    main()

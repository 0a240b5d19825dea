"""No-partition hash join (PHT/NPO family) as a build/probe pipeline
(counterpart of aqp_tpu/ops/pallas/nphj.py).

The reference's defining structure is ONE shared hash table over R, built
once and then probed as a stream.  Here, as in the reference, the table is
HASH-ORDERED: R's packed keys sigma(key)<<1 | 0 are routed by rho3's K1 + K2
into fine slots (f1, nbg_r, f2, cap2), a persistent artifact that any number
of probes reuse.

  build  nphj_build: pack R with tag 0, route_2level -> (tk2, tp2, tcnt).
  probe  nphj_probe: pack S with tag 1 under the same salt, route it the
         same way into (f1, nbg_s, f2, cap2), then K3TWO: per (f1, f2)
         region, every S element whose R partner (packed key - 1) is in the
         region's table runs matches; the count and r_pay + s_pay mod 2^32.
  K3TWO_MAT  K3TWO with region-chunked output columns of the reference's
         length f1 * f2 * w, w = 2 * max(nbg_r, nbg_s) * cap2, holes
         (-3, 0, 0).

Exact for unique R keys.  Slot overflow and keys outside the packed domain
are REPORTED in the overflow count; callers re-salt or use the exact core.

K3TWO and K3TWO_MAT have plain PyTorch versions (`k3two_plain`,
`k3two_mat_plain`) and wrappers (`k3two`, `k3two_mat`): a CPU tensor takes
the plain version, a CUDA tensor the kernel in csrc/nphj.cu, never a
fallback.  `LAUNCHES` counts the kernel launches.  The table keeps its
per-slot counts beside it (the port's slots are counted, where the
reference pads them), so build returns them and probe takes them.

Deliberate differences from the reference: with a duplicate R key the
first table run that holds it answers (the reference takes the last R in
merge order; counts agree, the checksum and the materialized R payload of
such an input are undefined in both); matches and the checksum are int64,
the checksum in [0, 2^32).

Variant geometry (the reference's build variants are compile-time knobs):
  PHT, NPO_st     defaults (f1 = 36, f2 = 16, kd = 64)
  PHT_no, NPO_no  f1 = 48: lower per-slot load
  PHT_un          f2 = 32, kd = 32: finer fan-out per pass
  PHT_o           f2 = 8, kd = 128: coarser buckets, longer runs
The skew tier's residual runs each variant at kd = 128.
"""

from __future__ import annotations

import dataclasses

import torch

from aqp_tpu_torch.ops.kernels import build
from aqp_tpu_torch.ops.kernels.build import need, on_cuda, ptr, stream
from aqp_tpu_torch.ops.kernels.rho3 import (HASH_C, HASH_MASK, Rho3Params,
                                            _as_i32, _modinv_pow2,
                                            _region_join, check_region_cap,
                                            halving_counter, k3_plain,
                                            pack_keys, route_2level,
                                            subranges)

VARIANT_PARAMS = {
    "PHT": Rho3Params(),
    "NPO_st": Rho3Params(),
    # more buckets -> lower per-slot load
    "PHT_no": Rho3Params(f1=48),
    "NPO_no": Rho3Params(f1=48),
    "PHT_un": Rho3Params(f2=32, kd_slot_rows=32),
    "PHT_o": Rho3Params(f2=8, kd_slot_rows=128),
}

LAUNCHES = {"K3TWO": 0, "K3TWO_MAT": 0}

_U32 = 0xFFFFFFFF


def _make_pipeline(prm: Rho3Params):
    def pipe(rk, rp, sk, sp, salt, with_checksum):
        return nphj_join_count(rk, rp, sk, sp, prm=prm, salt=salt,
                               with_checksum=with_checksum)
    return pipe


# per-variant residual pipelines for joins/skewtier.skew_fused_count
VARIANT_PIPELINES = {k: _make_pipeline(v) for k, v in VARIANT_PARAMS.items()}

# the skew residual's geometry: kd_slot_rows = 128 doubles the fine-slot
# slack, so the Zipf tail left after the heavy split fits
VARIANT_PIPELINES_SKEW = {
    k: _make_pipeline(dataclasses.replace(v, kd_slot_rows=128))
    for k, v in VARIANT_PARAMS.items()
}


# ---------------------------------------------------------------------------
# Plain versions


def _joined(tk2, tp2, tcnt, sk2, sp2, scnt):
    """The table's runs, then S's, as one run axis: the array K3's plain
    version takes (the first run that holds a partner answers, so a table
    run always does)."""
    return (torch.cat([tk2, sk2], 1),
            None if tp2 is None else torch.cat([tp2, sp2], 1),
            torch.cat([tcnt, scnt], 1))


def _check_sides(tp2, sp2) -> None:
    if (tp2 is None) != (sp2 is None):
        raise ValueError("payloads must be given for both the table and S, "
                         "or for neither")


def k3two_plain(tk2, tp2, tcnt, sk2, sp2, scnt):
    """K3TWO in plain PyTorch.  Table slots (f1, nbg_r, f2, cap2) with
    counts (f1, nbg_r, f2), S slots (f1, nbg_s, f2, cap2) with counts;
    payloads on both sides or neither.  Returns (matches, checksum) as
    0-dim int64 tensors, the checksum in [0, 2^32) (0 without payloads)."""
    _check_sides(tp2, sp2)
    return k3_plain(*_joined(tk2, tp2, tcnt, sk2, sp2, scnt))


def mat_chunk(nbg_r: int, nbg_s: int, cap2: int) -> int:
    """Elements per region of the materialized columns: the reference's
    w * 128 with w = 2 * max(nbg_r, nbg_s) * kd."""
    return 2 * max(nbg_r, nbg_s) * cap2


def k3two_mat_plain(tk2, tp2, tcnt, sk2, sp2, scnt, inv: int):
    """K3TWO_MAT in plain PyTorch.  Returns (matches, checksum, key,
    r_payload, s_payload): the scalars as k3two_plain's, the columns int32
    of length f1 * f2 * w (mat_chunk).  A matched S element of run j at
    slot position e of region (a, b) writes (((packed >> 1) * inv) mod
    2^30, R payload, S payload) at (a * f2 + b) * w + j * cap2 + e; every
    other position holds (-3, 0, 0)."""
    if tp2 is None or sp2 is None:
        raise ValueError("K3TWO_MAT needs the payloads")
    f1, nbg_r, f2, cap2 = tk2.shape
    nbg_s = sk2.shape[1]
    pos, key, hit, r_pay, s_pay = _region_join(
        *_joined(tk2, tp2, tcnt, sk2, sp2, scnt))
    nrun = nbg_r + nbg_s
    e = pos % cap2
    b = pos // cap2 % f2
    j = pos // (cap2 * f2) % nrun - nbg_r
    a = pos // (cap2 * f2 * nrun)
    w = mat_chunk(nbg_r, nbg_s, cap2)
    q = ((a * f2 + b) * w + j * cap2 + e)[hit]
    dev = tk2.device
    n = f1 * f2 * w
    ok = torch.full((n,), -3, dtype=torch.int32, device=dev)
    orp = torch.zeros((n,), dtype=torch.int32, device=dev)
    osp = torch.zeros((n,), dtype=torch.int32, device=dev)
    ok[q] = (((key[hit] >> 1) * inv) & HASH_MASK).to(torch.int32)
    orp[q] = _as_i32(r_pay[hit])
    osp[q] = _as_i32(s_pay[hit])
    ck = torch.where(hit, (r_pay + s_pay) & _U32, 0)
    return hit.sum(), ck.sum() & _U32, ok, orp, osp


# ---------------------------------------------------------------------------
# Wrappers: CPU tensor -> plain version, CUDA tensor -> kernel


def _check_slots(tk2, tp2, tcnt, sk2, sp2, scnt, dev):
    f1, nbg_r, f2, cap2 = tk2.shape
    nbg_s = sk2.shape[1]
    need(tk2, "tk2", (f1, nbg_r, f2, cap2), dev)
    need(tp2, "tp2", (f1, nbg_r, f2, cap2), dev)
    need(tcnt, "tcnt", (f1, nbg_r, f2), dev)
    need(sk2, "sk2", (f1, nbg_s, f2, cap2), dev)
    need(sp2, "sp2", (f1, nbg_s, f2, cap2), dev)
    need(scnt, "scnt", (f1, nbg_s, f2), dev)
    return f1, nbg_r, nbg_s, f2, cap2


def k3two(tk2, tp2, tcnt, sk2, sp2, scnt):
    """K3TWO: the table probed by S's slots (see k3two_plain)."""
    if not on_cuda(sk2):
        return k3two_plain(tk2, tp2, tcnt, sk2, sp2, scnt)
    _check_sides(tp2, sp2)
    dev = sk2.device
    f1, nbg_r, nbg_s, f2, cap2 = _check_slots(tk2, tp2, tcnt, sk2, sp2,
                                              scnt, dev)
    lib = build.load()
    check_region_cap(lib, cap2, "K3TWO")
    matches = torch.zeros((), dtype=torch.int64, device=dev)
    checksum = torch.zeros((), dtype=torch.int32, device=dev)
    err = lib.nphj_k3two(ptr(tk2), ptr(tp2), ptr(tcnt), nbg_r, ptr(sk2),
                         ptr(sp2), ptr(scnt), nbg_s, f1, f2, cap2,
                         subranges(nbg_r + nbg_s, cap2), ptr(matches),
                         ptr(checksum), ptr(halving_counter(dev)),
                         stream(dev))
    build.check(lib, err, "nphj K3TWO")
    LAUNCHES["K3TWO"] += 1
    return matches, checksum.long() & _U32


def k3two_mat(tk2, tp2, tcnt, sk2, sp2, scnt, inv: int):
    """K3TWO_MAT: K3TWO with materialized columns (see k3two_mat_plain), on
    K3TWO's sub-ranges; adds to the device's halving counter as K3TWO."""
    if not on_cuda(sk2):
        return k3two_mat_plain(tk2, tp2, tcnt, sk2, sp2, scnt, inv)
    if tp2 is None or sp2 is None:
        raise ValueError("K3TWO_MAT needs the payloads")
    dev = sk2.device
    f1, nbg_r, nbg_s, f2, cap2 = _check_slots(tk2, tp2, tcnt, sk2, sp2,
                                              scnt, dev)
    lib = build.load()
    check_region_cap(lib, cap2, "K3TWO_MAT")
    n = f1 * f2 * mat_chunk(nbg_r, nbg_s, cap2)
    ok = torch.empty((n,), dtype=torch.int32, device=dev)
    orp = torch.empty_like(ok)
    osp = torch.empty_like(ok)
    matches = torch.zeros((), dtype=torch.int64, device=dev)
    checksum = torch.zeros((), dtype=torch.int32, device=dev)
    err = lib.nphj_k3two_mat(ptr(tk2), ptr(tp2), ptr(tcnt), nbg_r, ptr(sk2),
                             ptr(sp2), ptr(scnt), nbg_s, f1, f2, cap2,
                             subranges(nbg_r + nbg_s, cap2), inv, ptr(ok),
                             ptr(orp), ptr(osp), ptr(matches), ptr(checksum),
                             ptr(halving_counter(dev)), stream(dev))
    build.check(lib, err, "nphj K3TWO_MAT")
    LAUNCHES["K3TWO_MAT"] += 1
    return matches, checksum.long() & _U32, ok, orp, osp


# ---------------------------------------------------------------------------
# Pipeline


def nphj_build(rk, rp, prm: Rho3Params = Rho3Params(), salt: int = HASH_C,
               with_payload: bool = True):
    """Build the shared hash-ordered table over R.

    Returns (tk2, tp2, tcnt, overflow): fine slots (f1, nbg_r, f2, cap2),
    their payloads (None when with_payload=False), their counts and the
    overflow + alias count (0-dim int64).  The table may be probed any
    number of times (nphj_probe)."""
    packed, alias = pack_keys(rk, torch.zeros_like(rk), salt)
    tk2, tp2, tcnt, _, ovf = route_2level(packed, rp if with_payload
                                          else None, prm, with_payload)
    return tk2, tp2, tcnt, ovf + alias


def _route_s(sk, sp, prm: Rho3Params, salt: int, with_payload: bool):
    packed, alias = pack_keys(sk, torch.ones_like(sk), salt)
    sk2, sp2, scnt, _, ovf = route_2level(packed, sp if with_payload
                                          else None, prm, with_payload)
    return sk2, sp2, scnt, ovf + alias


def _check_table(tk2, prm: Rho3Params) -> None:
    f1, _, f2, cap2 = tk2.shape
    if (f1, f2, cap2) != (prm.f1, prm.f2, prm.cap2):
        raise ValueError(f"the table's slots ({f1}, {f2}, {cap2}) are not "
                         f"prm's ({prm.f1}, {prm.f2}, {prm.cap2})")


def nphj_probe(tk2, tp2, tcnt, t_ovf, sk, sp,
               prm: Rho3Params = Rho3Params(), salt: int = HASH_C,
               with_checksum: bool = True):
    """Probe the table (nphj_build's output, built at the same prm and
    salt) with S.  Returns (matches, checksum, overflow) as 0-dim int64
    tensors; overflow > 0 means the result is invalid.  with_checksum
    needs a table built with payloads; without it no payload moves and
    the checksum is 0."""
    _check_table(tk2, prm)
    if with_checksum and tp2 is None:
        raise ValueError("the table was built without payloads")
    sk2, sp2, scnt, s_ovf = _route_s(sk, sp, prm, salt, with_checksum)
    m, c = k3two(tk2, tp2 if with_checksum else None, tcnt, sk2, sp2, scnt)
    return m, c, t_ovf + s_ovf


def nphj_join_count(rk, rp, sk, sp, prm: Rho3Params = Rho3Params(),
                    salt: int = HASH_C, with_checksum: bool = True):
    """Build + probe count join (the serving path).  Returns (matches,
    checksum, overflow)."""
    tk2, tp2, tcnt, t_ovf = nphj_build(rk, rp, prm, salt,
                                       with_payload=with_checksum)
    return nphj_probe(tk2, tp2, tcnt, t_ovf, sk, sp, prm, salt,
                      with_checksum)


def nphj_join_materialize(rk, rp, sk, sp, prm: Rho3Params = Rho3Params(),
                          salt: int = HASH_C):
    """Build + probe materializing join: region-chunked output columns of
    length f1 * f2 * w with holes (-3, 0, 0), w = mat_chunk(nbg_r, nbg_s,
    cap2).  Returns (matches, checksum, key, r_payload, s_payload,
    overflow)."""
    tk2, tp2, tcnt, t_ovf = nphj_build(rk, rp, prm, salt)
    sk2, sp2, scnt, s_ovf = _route_s(sk, sp, prm, salt, True)
    m, c, ok, orp, osp = k3two_mat(tk2, tp2, tcnt, sk2, sp2, scnt,
                                   _modinv_pow2(salt))
    return m, c, ok, orp, osp, t_ovf + s_ovf

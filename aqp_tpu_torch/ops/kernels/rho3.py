"""Fixed-slot two-level RHO join (counterpart of aqp_tpu/ops/pallas/rho3.py).

The pipeline and its constants are the reference's:

  pack_keys   packed = sigma(key)<<1 | tag with sigma = key*salt mod 2^30 (a
              bijection for odd salt), so R (tag 0) sorts just before the S
              copies (tag 1) of its key;
  K1          route each block of block_rows*128 packed keys into one fixed
              slot per level-1 bucket (f1 buckets);
  K2          route the bucket-f slots of `group` consecutive blocks (a
              window) into f2 fine slots;
  K3          per region (f1 bucket, f2 bucket): count the S elements whose
              R partner (packed key - 1) is in the region, and sum
              r_pay + s_pay over them mod 2^32;
  K3M         K3, and every matched S element writes (original key, R
              payload, S payload) at its own position of K2's slot layout;
              every other position carries the hole (-3, 0, 0).

Buckets are ranges of sigma, so equal keys always meet in one region.
Overflow of a slot, and any key outside [0, 2^30) or aliasing the pad, is
REPORTED in the overflow count, never answered wrongly.

Each of K1, K2, K3 and K3M has a plain PyTorch version (`k1_plain`, ...)
and a wrapper (`k1`, ...).  The wrapper sends a CPU tensor to the plain version
and a CUDA tensor to the hand-written kernel in csrc/rho3.cu; there is no
fallback from one to the other.  `LAUNCHES` counts the kernel launches.

Slot layout (both versions): a slot of capacity C holds its real elements
first, sorted by (key, payload as unsigned), then KEY_PAD_INT with payload
0; a count per slot says how many are real.  Capacity is counted in
ELEMENTS (rows*128), where the Pallas kernels count rows of a sorted block,
so it is never smaller: wherever the reference reports overflow == 0 this
pipeline does too, with the same slot contents, and it may succeed where
the reference overflows.  Overflow counts the elements that did not fit.
Which elements an overflowing K1 slot keeps is unspecified (the kernel
hands out positions with atomics); an overflowing K2 fine slot keeps the
first cap2 values of its sorted window, in both versions.  An overflowing
result is never used.
"""

from __future__ import annotations

from dataclasses import dataclass
import torch

from aqp_tpu_torch.ops.kernels import build
from aqp_tpu_torch.ops.kernels.build import need, on_cuda, ptr, stream

LANES = 128
KEY_PAD_INT = 2147483647    # int32 max: pads sort last, never a packed key

# real keys must stay below this (packed pad = KEY_PAD_INT = 2^31-1)
MAX_KEY = (1 << 30) - 2
# Designated input pads: any key in [MAX_KEY, 2^30) is dropped by K1.
PAD_R_INPUT = (1 << 30) - 2
PAD_S_INPUT = (1 << 30) - 1

HASH_C = 2654435761 & ((1 << 30) - 1)  # Knuth constant mod 2^30, odd
HASH_MASK = (1 << 30) - 1
# Salt ladder for overflow retries.
RETRY_SALTS = (HASH_C, 0x2545F491 | 1, 0x9E3779B9 & HASH_MASK | 1)

# Launches of each hand-written kernel in this process (the plain versions
# do not count).  Reset by assigning 0.
LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K3M": 0}

_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Rho3Params:
    block_rows: int = 1024   # rows per K1 block
    slot_rows: int = 32      # rows per (block, f1-bucket) slot
    f1: int = 36             # level-1 fanout (<= 127)
    f2: int = 16             # level-2 fanout per region (pow2, <= 127)
    kd_slot_rows: int = 64   # rows per (window, f2-bucket) fine slot

    @property
    def group(self) -> int:
        """K1 blocks whose slots make one K2 window."""
        return self.block_rows // self.slot_rows

    @property
    def block(self) -> int:
        return self.block_rows * LANES

    @property
    def cap1(self) -> int:
        return self.slot_rows * LANES

    @property
    def cap2(self) -> int:
        return self.kd_slot_rows * LANES

    @property
    def gmax(self) -> int:
        return self.f1 * self.f2

    def __post_init__(self):
        if self.block_rows % self.slot_rows:
            raise ValueError("block_rows must be a multiple of slot_rows")
        if self.slot_rows % 8 or self.kd_slot_rows % 8:
            raise ValueError("slot_rows and kd_slot_rows must be multiples of 8")
        if self.f2 & (self.f2 - 1):
            raise ValueError("f2 must be a power of two")
        if self.f1 + 1 > LANES or self.f2 + 1 > LANES:
            raise ValueError("f1 and f2 must be below 128")


def default_scale(prm: Rho3Params) -> float:
    """The sigma -> fine bucket scale gmax / 2^30, rounded to float32."""
    t = torch.tensor(prm.gmax / (1 << 30) * (1.0 - 1e-6), dtype=torch.float32)
    return t.item()


def _f32(x) -> float:
    """`x` rounded to float32, as a Python float that holds it exactly."""
    return torch.as_tensor(x, dtype=torch.float32).item()


def _fine_bucket(packed: torch.Tensor, scale: float, gmax: int) -> torch.Tensor:
    """Global fine bucket in [0, gmax) of real elements; gmax for high pads,
    -1 for low pads (packed < 0).  float32 arithmetic, as the reference."""
    sig = packed >> 1
    prod = sig.to(torch.float32) * torch.tensor(scale, dtype=torch.float32)
    g = prod.to(torch.int32).clamp(max=gmax - 1).clamp(min=0)
    g = torch.where(packed >= KEY_PAD_INT, gmax, g)
    return torch.where(packed < 0, -1, g)


def pack_keys(key: torch.Tensor, tag: torch.Tensor, salt: int):
    """packed = sigma(key)<<1 | tag, with input pads dropped and domain
    violations / pad-aliasing keys REPORTED.  Returns (packed int32,
    alias count as a 0-dim int64 tensor)."""
    k64 = key.long()
    sig = (k64 * salt) & HASH_MASK        # the reference's wrapping multiply
    drop = k64 >= MAX_KEY
    viol = ((k64 < 0) | (k64 >= (1 << 30))).sum()
    packed = torch.where(drop, KEY_PAD_INT, (sig << 1) | tag.long())
    alias = viol + ((sig == HASH_MASK) & ~drop).sum()
    return packed.to(torch.int32), alias


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length() if x > 1 else 1


def num_blocks(n: int, prm: Rho3Params) -> int:
    """K1 blocks for n packed keys: at least one window, a power of two."""
    return _next_pow2(max(-(-n // prm.block), prm.group))


# ---------------------------------------------------------------------------
# Plain versions


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation that sorts by keys[0], ties by keys[1], and so on."""
    perm = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


def _fill_slots(slot, key, pay, nslots: int, cap: int):
    """Place (slot, key, pay) elements into `nslots` slots of capacity cap:
    sorted by (key, payload as unsigned) within a slot, KEY_PAD_INT / 0
    behind.  Returns (keys, payloads or None, counts, overflow)."""
    dev = key.device
    full = torch.bincount(slot, minlength=nslots)
    ovf = (full - cap).clamp(min=0).sum()
    key = key.long()
    comp = slot * (1 << 32) + key   # real keys lie in [0, 2^31)
    perm = (_lexsort(comp) if pay is None
            else _lexsort(comp, pay.long() & _U32))
    slot, key = slot[perm], key[perm]
    starts = torch.cumsum(full, 0) - full
    rank = torch.arange(slot.numel(), device=dev) - starts[slot]
    keep = rank < cap
    pos = slot[keep] * cap + rank[keep]
    out_k = torch.full((nslots * cap,), KEY_PAD_INT, dtype=torch.int32,
                       device=dev)
    out_k[pos] = key[keep].to(torch.int32)
    out_p = None
    if pay is not None:
        out_p = torch.zeros((nslots * cap,), dtype=torch.int32, device=dev)
        out_p[pos] = pay[perm][keep].to(torch.int32)
    cnt = full.clamp(max=cap).to(torch.int32)
    return out_k, out_p, cnt, ovf


def k1_plain(packed, pay, nb: int, prm: Rho3Params, scale: float):
    """K1 in plain PyTorch.  packed[n] (+ pay[n]), n <= nb*block; keys past
    n are pads.  Returns (k1 (nb, f1, cap1), p1 or None, cnt1 (nb, f1),
    overflow)."""
    g = _fine_bucket(packed, _f32(scale), prm.gmax)
    real = (g >= 0) & (g < prm.gmax)
    blk = torch.arange(packed.numel(), device=packed.device) // prm.block
    slot = (blk * prm.f1 + g // prm.f2)[real]
    k, p, cnt, ovf = _fill_slots(slot, packed[real],
                                 None if pay is None else pay[real],
                                 nb * prm.f1, prm.cap1)
    shape = (nb, prm.f1, prm.cap1)
    return (k.view(shape), None if p is None else p.view(shape),
            cnt.view(nb, prm.f1), ovf)


def k2_plain(k1, p1, cnt1, prm: Rho3Params, scale: float):
    """K2 in plain PyTorch.  Returns (k2 (f1, nbg, f2, cap2), p2 or None,
    cnt2 (f1, nbg, f2), overflow)."""
    nb = k1.shape[0]
    nbg = nb // prm.group
    dev = k1.device
    live = torch.arange(prm.cap1, device=dev) < cnt1[..., None].long()
    blk, f, _ = torch.nonzero(live, as_tuple=True)
    key = k1[live]
    loc = _fine_bucket(key, _f32(scale), prm.gmax) - f * prm.f2
    ok = (loc >= 0) & (loc < prm.f2)
    slot = ((f * nbg + blk // prm.group) * prm.f2 + loc)[ok]
    k, p, cnt, ovf = _fill_slots(slot, key[ok],
                                 None if p1 is None else p1[live][ok],
                                 prm.f1 * nbg * prm.f2, prm.cap2)
    shape = (prm.f1, nbg, prm.f2, prm.cap2)
    return (k.view(shape), None if p is None else p.view(shape),
            cnt.view(prm.f1, nbg, prm.f2), ovf)


def _region_join(k2, p2, cnt2):
    """The region join of K3 and K3M in plain PyTorch.  Returns (pos,
    key, hit, r_pay, s_pay): per S element of the fine slots, its flat
    position in k2, its packed key, whether it matched, and (with payloads,
    else None) the answering R payload and its own payload, both as
    unsigned int64.

    An S element matches when its region holds its R partner (packed key
    - 1).  The first run (window index) that holds the partner decides, and
    within it the lowest (key, payload) copy: with a duplicate R key each S
    element still counts once, and the checksum is deterministic."""
    f1, nbg, f2, cap2 = k2.shape
    dev = k2.device
    live = torch.arange(cap2, device=dev) < cnt2[..., None].long()
    a, run, b, _ = torch.nonzero(live, as_tuple=True)
    key = k2[live].long()
    comp = (a * f2 + b) * (1 << 32) + key     # (region, packed key)
    is_s = (key & 1) == 1
    r_comp = comp[~is_s]
    if p2 is None:
        perm = _lexsort(r_comp)
    else:
        pay = p2[live].long() & _U32
        r_pay = pay[~is_s]
        perm = _lexsort(r_comp, run[~is_s], r_pay)
    r_comp = r_comp[perm]
    first = torch.ones_like(r_comp, dtype=torch.bool)
    first[1:] = r_comp[1:] != r_comp[:-1]
    # a leading -1 keeps the table non-empty; no S element looks it up
    none = torch.full((1,), -1, dtype=torch.int64, device=dev)
    u_comp = torch.cat([none, r_comp[first]])
    want = comp[is_s] - 1
    at = torch.searchsorted(u_comp, want).clamp(max=u_comp.numel() - 1)
    hit = u_comp[at] == want
    pos = torch.nonzero(live.view(-1), as_tuple=True)[0][is_s]
    if p2 is None:
        return pos, key[is_s], hit, None, None
    u_pay = torch.cat([none, r_pay[perm][first]])
    return pos, key[is_s], hit, u_pay[at], pay[is_s]


def k3_plain(k2, p2, cnt2):
    """K3 in plain PyTorch.  Returns (matches, checksum) as 0-dim int64
    tensors, the checksum in [0, 2^32) (0 without payloads).  Which R copy
    answers: see _region_join."""
    _, _, hit, r_pay, s_pay = _region_join(k2, p2, cnt2)
    matches = hit.sum()
    if p2 is None:
        return matches, torch.zeros((), dtype=torch.int64, device=k2.device)
    ck = torch.where(hit, (r_pay + s_pay) & _U32, 0)
    return matches, ck.sum() & _U32


def k3m_plain(k2, p2, cnt2, inv: int):
    """K3M in plain PyTorch.  Returns (matches, checksum, key, r_payload,
    s_payload): the scalars as k3_plain's, the columns int32 of k2's flat
    length.  A matched S element at flat position q of k2 writes
    (((packed >> 1) * inv) mod 2^30, R payload, S payload) at q; every
    other position holds (-3, 0, 0)."""
    pos, key, hit, r_pay, s_pay = _region_join(k2, p2, cnt2)
    dev = k2.device
    n = k2.numel()
    ok = torch.full((n,), -3, dtype=torch.int32, device=dev)
    orp = torch.zeros((n,), dtype=torch.int32, device=dev)
    osp = torch.zeros((n,), dtype=torch.int32, device=dev)
    q = pos[hit]
    ok[q] = (((key[hit] >> 1) * inv) & HASH_MASK).to(torch.int32)
    orp[q] = _as_i32(r_pay[hit])
    osp[q] = _as_i32(s_pay[hit])
    ck = torch.where(hit, (r_pay + s_pay) & _U32, 0)
    return hit.sum(), ck.sum() & _U32, ok, orp, osp


def _as_i32(u: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit values held in int64 back to their int32 bits."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


# ---------------------------------------------------------------------------
# Wrappers: CPU tensor -> plain version, CUDA tensor -> kernel


def _check_slot(lib, cap: int, k: int) -> None:
    """Raise unless kernel K<k> (K1 or K2) takes slots of cap elements."""
    most = lib.rho3_max_slot(k)
    if cap > most:
        raise ValueError(f"slots of {cap} exceed K{k}'s {most}")


def k1(packed, pay, nb: int, prm: Rho3Params, scale: float):
    """K1: route packed keys into level-1 slots (see k1_plain)."""
    if not on_cuda(packed):
        return k1_plain(packed, pay, nb, prm, scale)
    dev = packed.device
    n = packed.numel()
    need(packed, "packed", (n,), dev)
    need(pay, "pay", (n,), dev)
    if n > nb * prm.block:
        raise ValueError(f"{n} keys do not fit {nb} blocks of {prm.block}")
    lib = build.load()
    _check_slot(lib, prm.cap1, 1)
    out_k = torch.empty((nb, prm.f1, prm.cap1), dtype=torch.int32, device=dev)
    out_p = None if pay is None else torch.empty_like(out_k)
    cnt = torch.empty((nb, prm.f1), dtype=torch.int32, device=dev)
    ovf = torch.zeros((), dtype=torch.int64, device=dev)
    err = lib.rho3_k1(ptr(packed), ptr(pay), n, nb, prm.block, prm.f1,
                      prm.f2, _f32(scale), prm.cap1, ptr(out_k),
                      ptr(out_p), ptr(cnt), ptr(ovf), stream(dev))
    build.check(lib, err, "rho3 K1")
    LAUNCHES["K1"] += 1
    return out_k, out_p, cnt, ovf


def k2(k1_keys, p1, cnt1, prm: Rho3Params, scale: float):
    """K2: route level-1 windows into fine slots (see k2_plain)."""
    if not on_cuda(k1_keys):
        return k2_plain(k1_keys, p1, cnt1, prm, scale)
    dev = k1_keys.device
    nb = k1_keys.shape[0]
    if nb % prm.group:
        raise ValueError(f"{nb} blocks are not whole windows of {prm.group}")
    nbg = nb // prm.group
    need(k1_keys, "k1", (nb, prm.f1, prm.cap1), dev)
    need(p1, "p1", (nb, prm.f1, prm.cap1), dev)
    need(cnt1, "cnt1", (nb, prm.f1), dev)
    lib = build.load()
    _check_slot(lib, prm.cap2, 2)
    if prm.group > lib.rho3_max_group():
        raise ValueError(f"windows of {prm.group} K1 slots exceed K2's "
                         f"{lib.rho3_max_group()}")
    out_k = torch.empty((prm.f1, nbg, prm.f2, prm.cap2), dtype=torch.int32,
                        device=dev)
    out_p = None if p1 is None else torch.empty_like(out_k)
    cnt = torch.empty((prm.f1, nbg, prm.f2), dtype=torch.int32, device=dev)
    ovf = torch.zeros((), dtype=torch.int64, device=dev)
    err = lib.rho3_k2(ptr(k1_keys), ptr(p1), ptr(cnt1), prm.f1,
                      prm.group, prm.cap1, prm.f2, nbg, _f32(scale),
                      prm.cap2, ptr(out_k), ptr(out_p), ptr(cnt),
                      ptr(ovf), stream(dev))
    build.check(lib, err, "rho3 K2")
    LAUNCHES["K2"] += 1
    return out_k, out_p, cnt, ovf


# Fine-slot elements (of every run a region's CTAs read) one CTA of K3's,
# K3M's, K3TWO's or K3TWO_MAT's sub-range join, or of K3AGG's sub-range
# aggregate, covers: the P of a region is its runs' capacity over this.
# At the headline K3 takes P = 8 sub-ranges (~2,850 R keys a CTA) and
# K3TWO P = 10 (~2,280); fewer, larger CTAs were faster there.
SUBRANGE_ELEMS = 16384

# device -> the count of sub-ranges the region joins halved (their R did not
# fit one CTA) and of pieces K3AGG halved (their elements did not),
# accumulated over every K3, K3M, K3TWO, K3TWO_MAT and K3AGG launch on the
# device
_HALVINGS: dict = {}


def subranges(runs: int, cap2: int) -> int:
    """Key sub-ranges (CTAs) a region of `runs` fine slots of cap2 takes."""
    return max(1, -(-runs * cap2 // SUBRANGE_ELEMS))


def halving_counter(device) -> torch.Tensor:
    """The 0-dim int64 count of halved sub-ranges (pieces) that K3, K3M,
    K3TWO, K3TWO_MAT and K3AGG add to on `device`; zero it to start a
    count."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _HALVINGS:
        _HALVINGS[device] = torch.zeros((), dtype=torch.int64, device=device)
    return _HALVINGS[device]


def check_region_cap(lib, cap2: int, what: str) -> None:
    """Raise unless the region joins (csrc/region_join.cuh: K3, K3M, K3TWO
    and K3TWO_MAT) take fine slots of cap2 elements, up to
    rho3_k3_max_cap() (their shared memory does not grow with cap2)."""
    if cap2 > lib.rho3_k3_max_cap():
        raise ValueError(f"fine slots of {cap2} exceed {what}'s "
                         f"{lib.rho3_k3_max_cap()}")


def k3(k2_keys, p2, cnt2):
    """K3: region join, count + checksum (see k3_plain)."""
    if not on_cuda(k2_keys):
        return k3_plain(k2_keys, p2, cnt2)
    dev = k2_keys.device
    f1, nbg, f2, cap2 = k2_keys.shape
    need(k2_keys, "k2", (f1, nbg, f2, cap2), dev)
    need(p2, "p2", (f1, nbg, f2, cap2), dev)
    need(cnt2, "cnt2", (f1, nbg, f2), dev)
    lib = build.load()
    check_region_cap(lib, cap2, "K3")
    matches = torch.zeros((), dtype=torch.int64, device=dev)
    checksum = torch.zeros((), dtype=torch.int32, device=dev)
    err = lib.rho3_k3(ptr(k2_keys), ptr(p2), ptr(cnt2), f1, nbg, f2, cap2,
                      subranges(nbg, cap2), ptr(matches), ptr(checksum),
                      ptr(halving_counter(dev)), stream(dev))
    build.check(lib, err, "rho3 K3")
    LAUNCHES["K3"] += 1
    return matches, checksum.long() & _U32


def k3m(k2_keys, p2, cnt2, inv: int):
    """K3M: region join with materialized columns (see k3m_plain)."""
    if not on_cuda(k2_keys):
        return k3m_plain(k2_keys, p2, cnt2, inv)
    dev = k2_keys.device
    f1, nbg, f2, cap2 = k2_keys.shape
    need(k2_keys, "k2", (f1, nbg, f2, cap2), dev)
    if p2 is None:
        raise ValueError("K3M needs the payloads")
    need(p2, "p2", (f1, nbg, f2, cap2), dev)
    need(cnt2, "cnt2", (f1, nbg, f2), dev)
    lib = build.load()
    check_region_cap(lib, cap2, "K3M")
    n = k2_keys.numel()
    ok = torch.empty((n,), dtype=torch.int32, device=dev)
    orp = torch.empty_like(ok)
    osp = torch.empty_like(ok)
    matches = torch.zeros((), dtype=torch.int64, device=dev)
    checksum = torch.zeros((), dtype=torch.int32, device=dev)
    err = lib.rho3_k3m(ptr(k2_keys), ptr(p2), ptr(cnt2), f1, nbg, f2,
                       cap2, subranges(nbg, cap2), inv, ptr(ok), ptr(orp),
                       ptr(osp), ptr(matches), ptr(checksum),
                       ptr(halving_counter(dev)), stream(dev))
    build.check(lib, err, "rho3 K3M")
    LAUNCHES["K3M"] += 1
    return matches, checksum.long() & _U32, ok, orp, osp


# ---------------------------------------------------------------------------
# Pipeline


def route_2level(packed, pay, prm: Rho3Params, with_payload: bool,
                 scale=None):
    """Two-level fixed-slot routing (K1 + K2) of one packed array.

    Returns (k2, p2, cnt2, nbg, overflow): fine slots (f1, nbg, f2, cap2),
    their payloads (None when with_payload=False), their counts, the window
    count and the overflow (0-dim int64).

    `scale` overrides the sigma -> bucket map gmax/2^30 (bucket =
    min(int(sigma * scale), gmax - 1), in float32)."""
    nb = num_blocks(packed.numel(), prm)
    scale = default_scale(prm) if scale is None else _f32(scale)
    k1k, k1p, cnt1, ovf1 = k1(packed, pay if with_payload else None, nb, prm,
                              scale)
    k2k, k2p, cnt2, ovf2 = k2(k1k, k1p, cnt1, prm, scale)
    return k2k, k2p, cnt2, nb // prm.group, ovf1 + ovf2


def pack_pair(rk, sk, salt: int):
    """R's and S's keys packed as one array under `salt`, R first (tag 0),
    then S (tag 1): the pipeline's input.  Returns pack_keys' (packed,
    alias count)."""
    key = torch.cat([rk, sk])
    tag = torch.cat([torch.zeros_like(rk), torch.ones_like(sk)])
    return pack_keys(key, tag, salt)


def _partition_2level(rk, rp, sk, sp, prm: Rho3Params, salt: int,
                      with_payload: bool, scale):
    """Pack R and S under `salt` and route them into fine slots.  Returns
    (k2, p2, cnt2, overflow + alias count)."""
    packed, alias = pack_pair(rk, sk, salt)
    pay = torch.cat([rp, sp]) if with_payload else None
    k2k, k2p, cnt2, _, ovf = route_2level(packed, pay, prm, with_payload,
                                          scale=scale)
    return k2k, k2p, cnt2, ovf + alias


def rho_join_count_v3(rk, rp, sk, sp, prm: Rho3Params = Rho3Params(),
                      salt: int = HASH_C, with_checksum: bool = True,
                      scale=None):
    """Fused two-level fixed-slot RHO count join.

    Returns (matches, checksum, overflow) as 0-dim int64 tensors.
    overflow > 0 means the result is invalid (a slot overflowed under
    duplicate-key skew, or a key lies outside [0, 2^30) or aliases the pad);
    callers retry with another odd `salt` or use the exact core.

    with_checksum=False runs the keys-only pipeline: no payload moves, and
    the checksum is 0; `sp` is not read then."""
    k2k, k2p, cnt2, ovf = _partition_2level(rk, rp, sk, sp, prm, salt,
                                            with_checksum, scale)
    m, c = k3(k2k, k2p, cnt2)
    return m, c, ovf


def _modinv_pow2(salt: int, bits: int = 30) -> int:
    """Inverse of an odd multiplier mod 2^bits by 2-adic Newton steps, in
    int32 arithmetic as the reference computes it."""
    def i32(x):
        x &= 0xFFFFFFFF
        return x - (1 << 32) if x >= (1 << 31) else x

    inv = salt = i32(salt)
    for _ in range(5):
        inv = i32(inv * i32(2 - i32(salt * inv)))
    return inv & ((1 << bits) - 1)


def rho_join_materialize_v3(rk, rp, sk, sp, prm: Rho3Params = Rho3Params(),
                            salt: int = HASH_C, scale=None):
    """Fused two-level fixed-slot RHO join with MATERIALIZED output columns.

    Returns (matches, checksum, out_key, out_rpay, out_spay, overflow).
    The columns are REGION-CHUNKED with holes, f1*nbg*f2*cap2 long (the
    reference's length): every matched S row appears exactly once as
    (key, R payload, S payload), at its own position of K2's fine-slot
    layout; every other position carries the sentinel key -3 (never a real
    key) and zero payloads.  Consumers iterate it (the sentinel never
    matches in a further join) or compact it with
    ops/mergejoin.compact_matches.  Payloads always move."""
    k2k, k2p, cnt2, ovf = _partition_2level(rk, rp, sk, sp, prm, salt, True,
                                            scale)
    m, c, ok, orp, osp = k3m(k2k, k2p, cnt2, _modinv_pow2(salt))
    return m, c, ok, orp, osp, ovf

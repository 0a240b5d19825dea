"""Heavy-hitter split for the fixed-slot pipeline (counterpart of
aqp_tpu/joins/skewtier.py).

A key that fills a slot overflows under every salt: the same key lands in
the same bucket under any bijection.  So the skew tier splits it off:

  1. DETECT up to H candidate heavy S keys from a strided sample (the
     longest runs of the sorted sample).  A missed heavy key only makes the
     residual pipeline overflow, which is reported and escalates.
  2. R-SIDE STATS: per candidate, its count and payload sum over R.  Unique
     R keys make its contribution closed-form:
         matches_h  = present_R(h) * cnt_S(h)
         checksum_h = cnt_S(h) * r_payload(h) + sum_S_payload(h) (mod 2^32)
  3. SPLIT PASS over S: one pass that counts and sums the rows whose key is
     a present candidate and remaps every candidate row to the pipeline's
     input pad (dropped at K1).
  4. RESIDUAL: the fixed-slot pipeline on the remapped S, optionally
     COMPACTED first (ops/kernels/lanecompact.py) to a capacity the sampled
     heavy mass chooses (skew_plan), so that high skew leaves a small
     residual.

Total = residual + closed-form heavy part, exact for unique R keys.  Every
step but the pipeline and the compaction is plain PyTorch; candidate
matching is a binary search of each row in the sorted candidate list,
which computes what the reference's H unrolled compares compute.
"""

from __future__ import annotations

import torch

from aqp_tpu_torch.ops.kernels.lanecompact import (compact_k_fast,
                                                   compact_kp_fast)
from aqp_tpu_torch.ops.kernels.rho3 import (MAX_KEY, PAD_S_INPUT, Rho3Params,
                                            rho_join_count_v3,
                                            rho_join_materialize_v3)
from aqp_tpu_torch.ops.kernels.rstats import Candidates, r_cand_stats_kernel
from aqp_tpu_torch.ops.mergejoin import last_index
from aqp_tpu_torch.utils.cache import cached_by_tensor, update_cached

# Candidates: the residual pipeline's per-key overflow threshold is set by
# K2's fine-slot slack times the window count (see _skew_prm); at Zipf z in
# [1, 2] the keys above it are the top ~45 ranks, so 64 cover them.
H = 64
SAMPLE_STRIDE = 128
# a sampled run must repeat this often to be a candidate
MIN_SAMPLE_RUN = 8
# the dispatch hint's much stricter bound: only keys within ~3.5x of the
# slot-overflow mass justify taking the heavy-split tier first
HINT_MIN_RUN = 512
# residual-capacity ladder (fractions of |S|): few buffer sizes that track
# the sampled heavy mass
_TIER_FRACS = (0.125, 0.1875, 0.25, 0.375, 0.5, 0.75)

_U32 = 0xFFFFFFFF


def _sample_runs(s_key: torch.Tensor, stride: int):
    """(sorted strided sample, run length at each run's last element, 0
    elsewhere)."""
    sample = torch.sort(s_key[::stride]).values
    n = sample.numel()
    start = torch.ones(n, dtype=torch.bool, device=sample.device)
    start[1:] = sample[1:] != sample[:-1]
    end = torch.ones_like(start)
    end[:-1] = start[1:]
    idx = torch.arange(n, device=sample.device)
    return sample, torch.where(end, idx - last_index(start) + 1, 0)


def heavy_candidates(s_key: torch.Tensor, h: int = H,
                     stride: int = SAMPLE_STRIDE) -> torch.Tensor:
    """Up to h candidate heavy keys from a strided sample: int32 (h,),
    ascending, slots without a qualifying run hold -1.  Only keys in the
    pipeline's domain [0, MAX_KEY) qualify.  Among equal run lengths the
    run that ends first in the sorted sample wins, as jax.lax.top_k keeps
    the lower index on ties."""
    sample, length = _sample_runs(s_key, stride)
    pos = torch.sort(length, descending=True, stable=True).indices[:h]
    key_at = sample[pos]
    qual = (length[pos] >= MIN_SAMPLE_RUN) & (key_at >= 0) & (key_at < MAX_KEY)
    out = torch.full((h,), -1, dtype=torch.int32, device=s_key.device)
    out[:pos.numel()] = torch.where(qual, key_at, -1).to(torch.int32)
    return torch.sort(out).values


def r_cand_stats(rk, rp, hk, with_pay: bool = True):
    """Per candidate, (count, payload sum mod 2^32) over R as int64 (h,);
    a slot holding -1 (or any negative key) counts nothing.  Payload sums
    are 0 when with_pay=False.  RSTATS on a CUDA tensor, its plain version
    on a CPU tensor (ops/kernels/rstats.py)."""
    return r_cand_stats_kernel(rk, rp, hk, with_pay)


# the reference's name of its kernel form (one function serves both here)
r_cand_stats_pallas = r_cand_stats


def _split(sk, hk, pres, rph):
    """Per S row: heavy (its key is a candidate), hit (a candidate present
    in R) and the R payload it joins (the sum of rph over present candidate
    slots equal to its key, mod 2^32)."""
    cand = Candidates(hk)
    pres_s = pres[cand.order].long()
    rph_s = torch.where(pres_s > 0, rph[cand.order].long() & _U32, 0)
    gp = cand.group_sum(pres_s) > 0
    gr = cand.group_sum(rph_s) & _U32
    g, heavy = cand.lookup(sk)
    hit = heavy & gp[g]
    return heavy, hit, torch.where(hit, gr[g], 0)


def heavy_split_pass(sk, sp, hk, pres, rph, with_pay: bool = True):
    """One pass over S.  pres[c] (bool): candidate c present in R; rph[c]:
    its R payload.  Returns (mh, ch, sk_res): the rows whose key is a
    present candidate (the heavy matches), the sum over them of rph + s
    payload mod 2^32 (0 when with_pay=False), and the keys with every
    candidate's rows remapped to the input pad."""
    heavy, hit, rpof = _split(sk, hk, pres, rph)
    mh = hit.sum()
    if with_pay:
        ch = torch.where(hit, (rpof + (sp.long() & _U32)) & _U32, 0).sum()
        ch = ch & _U32
    else:
        ch = torch.zeros((), dtype=torch.int64, device=sk.device)
    return mh, ch, torch.where(heavy, PAD_S_INPUT, sk)


def _skew_prm() -> Rho3Params:
    """Residual geometry: kd_slot_rows=128 doubles K2's fine-slot slack,
    raising the per-key overflow threshold that the Zipf tail left after
    the H candidates must stay below."""
    return Rho3Params(kd_slot_rows=128)


def skew_fused_count(rk, rp, sk, sp, salt: int, with_checksum: bool = True,
                     pipeline=None, resid_cap_rows: int = 0,
                     r_dense: bool = False):
    """Heavy-split count join: candidates, R-side stats, the split pass and
    the residual pipeline.  Returns (matches, checksum, overflow).

    `pipeline(rk, rp, sk, sp, salt, with_checksum) -> (m, c, ovf)` is the
    residual engine: None takes RHO's pipeline at _skew_prm(); the
    no-partition family passes its own build/probe pipeline
    (ops/kernels/nphj.VARIANT_PIPELINES_SKEW), so PHT keeps its identity
    under skew.

    resid_cap_rows > 0 COMPACTS the remapped S to that many 128-wide rows
    before the residual pipeline (the plan's capacity is also the keep-rate
    estimate that sizes the compaction windows).  A compaction that does
    not fit is reported through overflow; callers escalate.  r_dense (R
    proven to be {1..|R|}, keys-only) makes presence closed-form: no pass
    over R."""
    hk = heavy_candidates(sk)
    if r_dense and not with_checksum:
        pres = (hk >= 1) & (hk <= rk.numel())
        rph = torch.zeros(hk.shape, dtype=torch.int64, device=hk.device)
    else:
        rcnt, rph = r_cand_stats(rk, rp, hk, with_pay=with_checksum)
        pres = (hk >= 0) & (rcnt > 0)
    mh, ch, sk_res = heavy_split_pass(sk, sp, hk, pres, rph,
                                      with_pay=with_checksum)
    ovf_extra = torch.zeros((), dtype=torch.int64, device=sk.device)
    if resid_cap_rows > 0:
        kf = min(1.0, resid_cap_rows * 128 / max(1, sk.numel()))
        if with_checksum:
            sk_res, sp, ovf_extra = compact_kp_fast(
                sk_res, sp, resid_cap_rows, pad_key=PAD_S_INPUT,
                keep_frac=kf)
        else:
            sk_res, ovf_extra = compact_k_fast(
                sk_res, resid_cap_rows, pad_key=PAD_S_INPUT, keep_frac=kf)
            sp = torch.zeros_like(sk_res)
    if pipeline is None:
        m, c, ovf = rho_join_count_v3(rk, rp, sk_res, sp, salt=salt,
                                      with_checksum=with_checksum,
                                      prm=_skew_prm())
    else:
        m, c, ovf = pipeline(rk, rp, sk_res, sp, salt, with_checksum)
    return m + mh, (c + ch) & _U32, ovf + ovf_extra


def rho_skew_fused_count(rk, rp, sk, sp, salt: int,
                         with_checksum: bool = True, resid_cap_rows: int = 0,
                         r_dense: bool = False):
    """skew_fused_count with RHO's residual pipeline."""
    return skew_fused_count(rk, rp, sk, sp, salt,
                            with_checksum=with_checksum,
                            resid_cap_rows=resid_cap_rows, r_dense=r_dense)


def heavy_contrib(rk, rp, sk, sp, hk):
    """Closed-form contribution of the candidate keys and the residual S
    keys.  Returns (matches, checksum, sk_residual)."""
    rcnt, rph = r_cand_stats(rk, rp, hk, with_pay=True)
    pres = (hk >= 0) & (rcnt > 0)
    return heavy_split_pass(sk, sp, hk, pres, rph, with_pay=True)


def rho_skew_split_count(rk, rp, sk, sp, salt: int):
    """Heavy-split count join at the default geometry.  Returns (matches,
    checksum, overflow)."""
    hk = heavy_candidates(sk)
    mh, ch, sk_res = heavy_contrib(rk, rp, sk, sp, hk)
    m, c, ovf = rho_join_count_v3(rk, rp, sk_res, sp, salt=salt)
    return m + mh, (c + ch) & _U32, ovf


# ---------------------------------------------------------------------------
# Sampled skew statistics, computed once per probe key tensor.

_HINT_CACHE: dict = {}


def _sample_stats(s_key: torch.Tensor):
    """(max_run, qualifying_mass, n_sample) of the strided sample, as
    Python ints: max_run drives the dispatch hint; qualifying_mass /
    n_sample estimates the heavy fraction (the top-H runs of at least
    MIN_SAMPLE_RUN)."""
    _, length = _sample_runs(s_key, SAMPLE_STRIDE)
    if length.numel() == 0:   # an empty S: no run, so no hint and cap 0
        return 0, 0, 0
    top = torch.topk(length, min(H, length.numel())).values
    mass = torch.where(top >= MIN_SAMPLE_RUN, top, 0).sum()
    mx, mass = torch.stack([length.max(), mass]).tolist()
    return mx, mass, length.numel()


def _plan(s_key: torch.Tensor):
    mx, mass, n = _sample_stats(s_key)
    hinted = bool(mx >= HINT_MIN_RUN)
    cap_rows = 0
    if hinted:
        light = 1.0 - float(mass) / float(n)
        need = min(1.0, light * 1.15 + 0.02)
        for f in _TIER_FRACS:
            if f >= need:
                # whole output rows (128 elements) for the lane compactor
                cap_rows = -(-int(s_key.shape[0] * f) // 128)
                break
    return hinted, cap_rows


def skew_plan(s_key: torch.Tensor):
    """(hinted, resid_cap_rows), cached per tensor.

    hinted: the sample holds a run long enough to take the heavy-split
    tier first.  resid_cap_rows > 0 selects the compacted-residual tier:
    the smallest ladder fraction covering the sampled light mass with ~15%
    plus sampling margin; 0 runs the full-capacity skew tier (mild skew:
    below ~25% heavy mass the compaction would not pay for itself)."""
    return cached_by_tensor(_HINT_CACHE, s_key, _plan)


def demote_resid(s_key: torch.Tensor) -> None:
    """The sampled residual capacity overflowed for this probe tensor:
    rewrite its cached plan to cap_rows=0, so later calls take the
    full-capacity skew tier directly instead of failing the compacted one
    again."""
    update_cached(_HINT_CACHE, s_key, lambda plan: (plan[0], 0))


def skew_hint(s_key: torch.Tensor) -> bool:
    """Does the strided sample hold a run long enough for the hint?"""
    return skew_plan(s_key)[0]


# ---------------------------------------------------------------------------
# Materializing skew path.


def heavy_materialize(rk, rp, sk, sp, hk):
    """Materialized heavy rows, IN PLACE (unique R keys make the heavy join
    a per-row map).  Returns (matches, checksum, key, r_payload, s_payload,
    sk_res): columns of |S|'s length with holes (key -3, payloads 0) at
    rows that are not a present candidate, and the residual S keys."""
    rcnt, rph = r_cand_stats(rk, rp, hk, with_pay=True)
    pres = (hk >= 0) & (rcnt > 0)
    heavy, hit, rpof = _split(sk, hk, pres, rph)
    out_rp = torch.where(rpof >= (1 << 31), rpof - (1 << 32), rpof)
    checksum = torch.where(hit, (rpof + (sp.long() & _U32)) & _U32, 0).sum()
    return (hit.sum(), checksum & _U32, torch.where(hit, sk, -3),
            out_rp.to(torch.int32), torch.where(hit, sp, 0),
            torch.where(heavy, PAD_S_INPUT, sk))


def rho_skew_split_materialize(rk, rp, sk, sp, salt: int):
    """Heavy-split materializing join: the residual pipeline's
    region-chunked columns followed by the in-place heavy columns (both
    with -3 holes).  Returns (matches, checksum, key, r_payload, s_payload,
    overflow)."""
    hk = heavy_candidates(sk)
    mh, ch, hk_col, hrp, hsp, sk_res = heavy_materialize(rk, rp, sk, sp, hk)
    m, c, ok, orp, osp, ovf = rho_join_materialize_v3(rk, rp, sk_res, sp,
                                                      salt=salt)
    return (m + mh, (c + ch) & _U32, torch.cat([ok, hk_col]),
            torch.cat([orp, hrp]), torch.cat([osp, hsp]), ovf)


"""Every kernel launch held to its plain version, where the joins call it.

`held_to_plain(held)` replaces the wrapper of each kernel in HELD_KERNELS,
in every module whose callers name it, by one that launches the kernel,
runs the kernel's plain version on the same inputs and raises unless the
outputs are equal; `held` gathers each kernel's held launches, largest
error and input shapes.  The routing and region kernels' plain versions run
in pieces (PLAIN_PIECE elements at most), so that a main path's largest
shapes can be held on the card beside the path's own tensors.

`chip_smoke.py` holds its phases' main paths with it, and each rank of
`experiments/dist_forms` its own launches.  On a CPU tensor a wrapper runs
the plain version itself, so the comparison holds plain against plain.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from aqp_tpu_torch.joins import skewtier
from aqp_tpu_torch.ops.kernels import (
    aggpipe, blocksort, compact, lanecompact, nphj, rho3, rstats)
from aqp_tpu_torch.ops.kernels import scan as kscan

U32 = 0xFFFFFFFF
# every wrapper's launch count, by module (each wrapper adds one where it
# launches its kernel)
COUNTERS = (rho3.LAUNCHES, lanecompact.LAUNCHES, compact.LAUNCHES,
            kscan.LAUNCHES, aggpipe.LAUNCHES, nphj.LAUNCHES, rstats.LAUNCHES,
            blocksort.LAUNCHES)


def reset_launches() -> None:
    for counter in COUNTERS:
        for k in counter:
            counter[k] = 0


def read_launches() -> dict:
    out = {}
    for counter in COUNTERS:
        out.update(counter)
    return out


class PlainMismatch(RuntimeError):
    """A kernel's output differs from its plain version's."""


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise PlainMismatch(what)



def max_abs_err(got, want) -> int:
    """Largest |got - want| over matching outputs (None must meet None)."""
    err = 0
    for g, w in zip(got, want):
        if g is None or w is None:
            _require(g is None and w is None, "an output is missing")
            continue
        _require(tuple(g.shape) == tuple(w.shape),
                 f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        d = (g.long() - w.long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def flat_outputs(name, out):
    if name.startswith("compact_windows"):
        blocks, counts = out
        return [*blocks, counts]
    return as_list(out)


PLAIN_PIECE = 1 << 26   # elements a piece of a plain version takes at most


def k1_err(got, packed, pay, nb, prm, scale) -> int:
    """K1's outputs against k1_plain run over runs of whole blocks (K1
    routes each block of prm.block inputs into that block's own slots),
    each piece held to its slice of the kernel's slots and counts; where
    a piece's slots overflowed, its counts alone (an overflowing slot keeps
    what K1's scatter placed first).  The overflows must sum to K1's."""
    per = max(1, PLAIN_PIECE // prm.block)
    err, ovf = 0, 0
    for b0 in range(0, nb, per):
        b1 = min(nb, b0 + per)
        cut = slice(b0 * prm.block, b1 * prm.block)
        want = rho3.k1_plain(packed[cut], None if pay is None else pay[cut],
                             b1 - b0, prm, scale)
        part = [None if g is None else g[b0:b1] for g in got[:3]]
        ovf += int(want[3])
        err = max(err, max_abs_err(part[2:], want[2:3]) if int(want[3])
                  else max_abs_err(part, want[:3]))
    _require(ovf == int(got[3]), f"K1 overflow {int(got[3])}, its plain "
             f"version {ovf}")
    return err


def k2_err(got, k1, p1, cnt1, prm, scale) -> int:
    """K2's outputs against k2_plain run over runs of whole windows
    (prm.group blocks, which K2 merges into the window's own fine slots),
    each piece held to its slice; the overflows must sum to K2's."""
    nbg = k1.shape[0] // prm.group
    per = max(1, PLAIN_PIECE // (prm.group * prm.block))
    err, ovf = 0, 0
    for w0 in range(0, nbg, per):
        w1 = min(nbg, w0 + per)
        cut = slice(w0 * prm.group, w1 * prm.group)
        want = rho3.k2_plain(k1[cut], None if p1 is None else p1[cut],
                             cnt1[cut], prm, scale)
        err = max(err, max_abs_err(
            [None if g is None else g[:, w0:w1] for g in got[:3]], want[:3]))
        ovf += int(want[3])
    _require(ovf == int(got[3]), f"K2 overflow {int(got[3])}, its plain "
             f"version {ovf}")
    return err


def region_err(plain):
    """A comparison for K3, K3M, K3TWO or K3TWO_MAT: `plain` run over runs
    of the fine slots' first axis, which no region spans; the pieces'
    matches and checksums (mod 2^32) summed against the kernel's, each
    piece's columns (which run region-major) against their slice of the
    kernel's."""
    def err_of(got, *args):
        f1 = args[0].shape[0]
        live = sum(int(a.sum()) for a in args
                   if isinstance(a, torch.Tensor) and a.dim() == 3)
        per = max(1, f1 * PLAIN_PIECE // max(1, live))
        err, m, c, at = 0, 0, 0, 0
        for i in range(0, f1, per):
            want = plain(*(a[i:i + per] if isinstance(a, torch.Tensor)
                           else a for a in args))
            m, c = m + int(want[0]), c + int(want[1])
            if len(want) > 2:
                n = want[2].numel()
                err = max(err, max_abs_err([g[at:at + n] for g in got[2:]],
                                           want[2:]))
                at += n
        if len(got) > 2:
            _require(at == got[2].numel(), f"the pieces cover {at} of "
                     f"{got[2].numel()} output rows")
        return max(err, abs(int(got[0]) - m), abs(int(got[1]) - (c & U32)))
    return err_of


def _pair_plain(ks, ps, soff, doff, sz, nseg, out_rows,
                fill_key=compact.KEY_PAD_INT):
    return compact.scatter_segments_plain([ks, ps], soff, doff, sz, out_rows,
                                          fill_key)


def _one_plain(ks, soff, doff, sz, nseg, out_rows,
               fill_key=compact.KEY_PAD_INT):
    return compact.scatter_segments_plain([ks], soff, doff, sz, out_rows,
                                          fill_key)[0]


def whole_err(name, plain):
    """A comparison against one call of the plain version, in phase 3's
    terms: the compactor's blocks and counts; a scatter's rows but the
    last (its callers drop it); else every output."""
    def err_of(got, *args, **kw):
        want = plain(*args, **kw)
        if name == "compact_windows":
            return max_abs_err(flat_outputs(name, got),
                               flat_outputs(name, want))
        if name.startswith("scatter"):
            return max_abs_err([g[:-1] for g in as_list(got)],
                               [w[:-1] for w in as_list(want)])
        return max_abs_err(as_list(got), as_list(want))
    return err_of


# kernel -> (the modules whose name for the wrapper the callers call, that
# name, the comparison with the plain version: in pieces for the routing
# and region kernels, whose whole plain output would not fit beside the
# main path's tensors at the sweeps' largest point)
HELD_KERNELS = {
    "K1": ((rho3,), "k1", k1_err),
    "K2": ((rho3,), "k2", k2_err),
    "K3": ((rho3,), "k3", region_err(rho3.k3_plain)),
    "K3M": ((rho3,), "k3m", region_err(rho3.k3m_plain)),
    "K3TWO": ((nphj,), "k3two", region_err(nphj.k3two_plain)),
    "K3TWO_MAT": ((nphj,), "k3two_mat", region_err(nphj.k3two_mat_plain)),
    "compact_windows": ((lanecompact,), "_compact_windows", whole_err(
        "compact_windows", lanecompact.compact_windows_plain)),
    "scatter_segments": ((lanecompact, aggpipe), "scatter_segments",
                         whole_err("scatter_segments", _pair_plain)),
    "scatter_segments_one": ((lanecompact, aggpipe), "scatter_segments_one",
                             whole_err("scatter_segments_one", _one_plain)),
    "RSTATS": ((skewtier,), "r_cand_stats_kernel",
               whole_err("RSTATS", rstats.r_cand_stats_plain)),
    "scan_count": ((kscan,), "count", whole_err("scan_count",
                                                kscan.count_plain)),
    "scan_sum": ((kscan,), "sum_", whole_err("scan_sum", kscan.sum_plain)),
    "scan_bitvector": ((kscan,), "bitvector",
                       whole_err("scan_bitvector", kscan.bitvector_plain)),
    "K3AGG": ((aggpipe,), "k3agg", whole_err("K3AGG", aggpipe.k3agg_plain)),
}


def _held_call(name, kernel, err_of, held, *args, **kw):
    if name == "compact_windows":   # its launch count is kept by form
        name = lanecompact._form(kw.get("with_ids", False),
                                 kw.get("with_values", False),
                                 kw.get("dict_tables"))
    got = kernel(*args, **kw)
    card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    if card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    err = err_of(got, *args, **kw)
    if card:
        torch.cuda.synchronize()
    shapes = [list(a.shape) for a in args if isinstance(a, torch.Tensor)]
    _require(err == 0, f"{name} differs from its plain version by {err} on "
             f"inputs {shapes}")
    rec = held.setdefault(name, {"launches": 0, "max_abs_err": 0,
                                 "inputs": []})
    rec["launches"] += 1
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    if shapes not in rec["inputs"]:
        rec["inputs"].append(shapes)
    return got


@contextlib.contextmanager
def held_to_plain(held):
    """Every wrapper of HELD_KERNELS, where the joins call it, replaced by
    one that launches the kernel, runs the plain version on the same
    inputs and requires equal outputs (its comparison in HELD_KERNELS);
    `held` gathers each kernel's held launches and input shapes."""
    saved = {}
    for name, (mods, attr, err_of) in HELD_KERNELS.items():
        for mod in mods:
            saved[(mod, attr)] = kernel = getattr(mod, attr)
            setattr(mod, attr, functools.partial(_held_call, name, kernel,
                                                 err_of, held))
    try:
        yield
    finally:
        for (mod, attr), kernel in saved.items():
            setattr(mod, attr, kernel)

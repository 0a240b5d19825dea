"""Per-tensor caches of derived facts (the dense-PK proof, the skew plan,
whether a key column holds an input-pad value)."""

from __future__ import annotations

import weakref

import torch


def cached_by_tensor(cache: dict, t: torch.Tensor, compute):
    """compute(t), cached in `cache` by the tensor's identity and version.

    The entry holds a weak reference, so it never keeps the tensor alive;
    it also holds the tensor's version counter, which every in-place write
    bumps, so a tensor changed in place is computed anew.  Tensors that
    keep no version counter (made under torch.inference_mode) are never
    cached."""
    try:
        version = t._version
    except RuntimeError:
        return compute(t)
    key = id(t)
    hit = cache.get(key)
    if hit is not None and hit[0]() is t and hit[1] == version:
        return hit[2]
    val = compute(t)
    if len(cache) >= 32:
        # drop the entries whose tensor has died; live ones stay
        for k in [k for k, e in cache.items() if e[0]() is None]:
            del cache[k]
    cache[key] = (weakref.ref(t), version, val)
    return val


def update_cached(cache: dict, t: torch.Tensor, fn) -> None:
    """Replace the value v of t's live cache entry by fn(v); without such an
    entry, do nothing."""
    hit = cache.get(id(t))
    if hit is not None and hit[0]() is t:
        cache[id(t)] = (hit[0], hit[1], fn(hit[2]))

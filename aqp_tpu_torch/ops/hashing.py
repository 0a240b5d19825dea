"""Integer hash functions for partitioning and hash tables (counterpart of
aqp_tpu/ops/hashing.py).

The radix family keeps bit-slicing "hashes" (bucket = key bits); the
open-addressing and bucket-chaining tables use a Fibonacci or murmur-style
mixer, so that adversarial key sets still spread.

The reference computes in uint32.  PyTorch has no uint32 arithmetic, so
these compute in int64 masked to 32 bits: the same bits.  Buckets come back
as int32, `murmur_mix32` as int64 in [0, 2^32) where the reference returns
uint32.
"""

from __future__ import annotations

import torch

GOLDEN32 = 0x9E3779B1
_U32 = 0xFFFFFFFF


def _u32(key: torch.Tensor) -> torch.Tensor:
    """The key's bits as an unsigned 32-bit value, held in int64."""
    return key.long() & _U32


def radix_bits(key: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    """bucket = (key >> shift) & (2^bits - 1).  An int64 key shifts in its
    own width; an int32 key as unsigned 32 bits."""
    mask = (1 << bits) - 1
    if key.dtype == torch.int64:
        return ((key >> shift) & mask).to(torch.int32)
    return ((_u32(key) >> shift) & mask).to(torch.int32)


def fib_hash32(key: torch.Tensor, table_bits: int) -> torch.Tensor:
    """Fibonacci multiplicative hash into [0, 2^table_bits).

    Bijective on 32 bits (odd multiplier), so unique keys stay unique in the
    full image; collisions come only from the cut to table_bits.  The int64
    product may wrap; its low 32 bits are the uint32 product's."""
    h = (_u32(key) * GOLDEN32) & _U32
    return (h >> (32 - table_bits)).to(torch.int32)


def murmur_mix32(key: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer, a full-avalanche bijection of 32 bits."""
    k = _u32(key)
    k = ((k ^ (k >> 16)) * 0x85EBCA6B) & _U32
    k = ((k ^ (k >> 13)) * 0xC2B2AE35) & _U32
    return k ^ (k >> 16)


def partition_hash(key: torch.Tensor, bits: int, salt: int = 0
                   ) -> torch.Tensor:
    """Hash-partition bucket in [0, 2^bits): the top bits of the mixed key
    (plus `salt`, mod 2^32)."""
    k = murmur_mix32(key if salt == 0 else (_u32(key) + salt) & _U32)
    return (k >> (32 - bits)).to(torch.int32)

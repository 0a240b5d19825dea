"""Seeded relation generators (counterpart of aqp_tpu/data/generator.py).

They keep the reference generators' distributional contract, so the
closed-form cardinality oracles carry over; the random bits differ from
`jax.random`'s (tests that compare the two packages make their inputs with
numpy and hand them to both):

- `create_relation_pk`: keys are exactly {1..n}, uniformly permuted.
- `create_relation_fk`: floor(n/maxid) independently permuted copies of
  {1..maxid}, then the first n mod maxid entries of one more permutation,
  so joining against the maxid-row PK relation gives exactly n matches.
- `create_relation_fk_sel`: matches with probability sel% per key.
- `create_relation_zipf`: Zipf(z)-skewed keys over a shuffled alphabet
  {1..alphabet_size}: rank r (from 1) has probability r^-z / sum_k k^-z.

Generation runs on `device` from a `torch.Generator` seeded with `seed`.
Payloads are zero, as in the reference, unless `random_payload` asks for
uniform int32 payloads, which make the join checksum non-trivial.
"""

from __future__ import annotations

import numpy as np
import torch

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.relation import Relation


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _relation(keys: torch.Tensor, gen: torch.Generator,
              random_payload: bool) -> Relation:
    if not random_payload:
        return Relation.from_keys(keys)
    pay = torch.randint(-(1 << 31), 1 << 31, keys.shape, generator=gen,
                        dtype=torch.int64, device=keys.device)
    return Relation(key=keys, payload=pay.to(keys.dtype))


def _perm1(n: int, gen: torch.Generator, device, dtype) -> torch.Tensor:
    """A uniform permutation of {1..n}."""
    return (torch.randperm(n, generator=gen, device=device) + 1).to(dtype)


def create_relation_pk(num_tuples: int, seed: int = 11111,
                       dtype=torch.int32, device="cuda",
                       random_payload: bool = False) -> Relation:
    """Dense unique primary keys {1..n}, shuffled."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    return _relation(_perm1(num_tuples, gen, dev, dtype), gen, random_payload)


def _fk_keys(num_tuples: int, maxid: int, gen, dev, dtype) -> torch.Tensor:
    full_blocks, rem = divmod(num_tuples, maxid)
    parts = [_perm1(maxid, gen, dev, dtype) for _ in range(full_blocks)]
    if rem:
        # a uniform random rem-subset in uniform random order
        parts.append(_perm1(maxid, gen, dev, dtype)[:rem])
    if not parts:
        return torch.zeros((0,), dtype=dtype, device=dev)
    return torch.cat(parts)


def create_relation_fk(num_tuples: int, maxid: int, seed: int = 22222,
                       dtype=torch.int32, device="cuda",
                       random_payload: bool = False) -> Relation:
    """Tiled foreign keys over {1..maxid}: exactly num_tuples matches against
    the maxid-row PK relation."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    return _relation(_fk_keys(num_tuples, maxid, gen, dev, dtype), gen,
                     random_payload)


def create_relation_fk_sel(num_tuples: int, r_tuples: int,
                           selectivity: float, seed: int = 22222,
                           dtype=torch.int32, device="cuda",
                           random_payload: bool = False) -> Relation:
    """FK relation with join selectivity `selectivity` in (0, 100].

    The reference widens the key domain to maxid = 100*|R|/sel.  Where that
    domain is small the keys are tiled over it; otherwise each key is a
    matching draw from {1..|R|} with probability sel/100, else a
    non-matching draw from (|R|, 2^30 - 8): the same match semantics in a
    bounded domain."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    maxid = int(round(100.0 * r_tuples / selectivity))
    if maxid <= 4 * num_tuples and maxid < (1 << 30) - 8:
        keys = _fk_keys(num_tuples, maxid, gen, dev, dtype)
        return _relation(keys, gen, random_payload)
    match = torch.rand(num_tuples, generator=gen, device=dev) < (
        selectivity / 100.0)
    hit = torch.randint(1, r_tuples + 1, (num_tuples,), generator=gen,
                        device=dev)
    miss = torch.randint(r_tuples + 1, (1 << 30) - 8, (num_tuples,),
                         generator=gen, device=dev)
    keys = torch.where(match, hit, miss).to(dtype)
    return _relation(keys, gen, random_payload)


def _zipf_cdf_lut(alphabet_size: int, zipf_factor: float) -> np.ndarray:
    """Normalized Zipf CDF over ranks 1..alphabet_size, in float64."""
    ranks = np.arange(1, alphabet_size + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** (-zipf_factor))
    return cdf / cdf[-1]


def zipf_ranks(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """0-based ranks of the float32 uniforms `u` under the float32 CDF: the
    first index whose CDF value is not below u, clamped to the alphabet."""
    return torch.searchsorted(cdf, u, side="left").clamp(0, cdf.numel() - 1)


def create_relation_zipf(num_tuples: int, alphabet_size: int,
                         zipf_factor: float, seed: int = 22222,
                         dtype=torch.int32, device="cuda",
                         random_payload: bool = False) -> Relation:
    """Zipf(z)-skewed FK keys over a shuffled alphabet {1..alphabet_size}:
    a uniform u in [0, 1) is looked up in the CDF table (float32), and the
    rank indexes a seeded permutation of the alphabet, so the heavy hitters
    are random key values, not small ones."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    cdf = torch.from_numpy(_zipf_cdf_lut(alphabet_size, zipf_factor)).to(
        device=dev, dtype=torch.float32)
    alphabet = _perm1(alphabet_size, gen, dev, dtype)
    u = torch.rand(num_tuples, generator=gen, dtype=torch.float32, device=dev)
    return _relation(alphabet[zipf_ranks(cdf, u)], gen, random_payload)


def oracle_matches_fk(num_s_tuples: int) -> int:
    """FK workload oracle: every S tuple matches exactly once."""
    return num_s_tuples

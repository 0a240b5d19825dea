"""The port's generators keep the reference's distributional contract."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aqp_tpu.data import generator as jgen
from aqp_tpu_torch.data import (create_relation_fk, create_relation_fk_sel,
                                create_relation_pk, create_relation_zipf,
                                oracle_matches_fk)
from aqp_tpu_torch.data import generator as tgen
from aqp_tpu_torch.ops import mergejoin


def test_pk_is_a_permutation_of_1_to_n():
    rel = create_relation_pk(10_000, seed=3, device="cpu")
    assert rel.key.dtype == torch.int32
    np.testing.assert_array_equal(np.sort(rel.key.numpy()),
                                  np.arange(1, 10_001))
    assert not torch.equal(rel.key, torch.arange(1, 10_001, dtype=torch.int32))
    assert int(rel.payload.abs().sum()) == 0


@pytest.mark.parametrize("n,maxid", [(40_000, 10_000), (25_000, 10_000),
                                     (3_000, 10_000)])
def test_fk_is_tiled_over_1_to_maxid(n, maxid):
    k = create_relation_fk(n, maxid, seed=4, device="cpu").key.numpy()
    assert k.size == n
    full, rem = divmod(n, maxid)
    for b in range(full):
        np.testing.assert_array_equal(np.sort(k[b * maxid:(b + 1) * maxid]),
                                      np.arange(1, maxid + 1))
    tail = k[full * maxid:]
    assert tail.size == rem
    assert np.unique(tail).size == rem
    assert tail.min(initial=1) >= 1 and tail.max(initial=maxid) <= maxid


def test_fk_join_pk_is_s():
    r = create_relation_pk(5_000, seed=1, device="cpu", random_payload=True)
    s = create_relation_fk(23_456, 5_000, seed=2, device="cpu",
                           random_payload=True)
    out = mergejoin.merge_join_count(r.key, r.payload, s.key, s.payload)
    assert int(out.matches) == oracle_matches_fk(23_456) == 23_456


def test_same_seed_same_data():
    a = create_relation_fk(7_000, 3_000, seed=9, device="cpu",
                           random_payload=True)
    b = create_relation_fk(7_000, 3_000, seed=9, device="cpu",
                           random_payload=True)
    c = create_relation_fk(7_000, 3_000, seed=10, device="cpu",
                           random_payload=True)
    assert torch.equal(a.key, b.key) and torch.equal(a.payload, b.payload)
    assert not torch.equal(a.key, c.key)
    assert a.payload.dtype == torch.int32
    assert int((a.payload != 0).sum()) > 6_900


@pytest.mark.parametrize("sel", [50.0, 1.0])
def test_fk_sel_matches_at_the_selectivity(sel):
    nr, ns = 20_000, 100_000
    s = create_relation_fk_sel(ns, nr, sel, seed=5, device="cpu").key
    assert int(s.min()) >= 1 and int(s.max()) < (1 << 30) - 8
    hit = float((s <= nr).float().mean()) * 100
    assert abs(hit - sel) < max(0.1 * sel, 0.3)


@pytest.mark.parametrize("alphabet,z", [(1 << 14, 1.5), (1000, 1.0),
                                        (7, 0.5)])
def test_zipf_cdf_lut_matches_reference(alphabet, z):
    want = jgen._zipf_cdf_lut(alphabet, z)
    got = tgen._zipf_cdf_lut(alphabet, z)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_zipf_rank_step_matches_jnp_searchsorted():
    cdf = jgen._zipf_cdf_lut(1 << 14, 1.5).astype(np.float32)
    rng = np.random.default_rng(8)
    u = np.concatenate([rng.random(1 << 16, dtype=np.float32),
                        cdf[:50], cdf[-50:], [0.0, np.nextafter(1, 0)]]
                       ).astype(np.float32)
    want = np.clip(np.asarray(jnp.searchsorted(
        jnp.asarray(cdf), jnp.asarray(u), side="left", method="sort")),
        0, cdf.size - 1)
    got = tgen.zipf_ranks(torch.from_numpy(cdf), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)


def test_zipf_keys_skew_and_determinism():
    a = create_relation_zipf(1 << 18, 5000, 1.5, seed=5, device="cpu")
    b = create_relation_zipf(1 << 18, 5000, 1.5, seed=5, device="cpu")
    c = create_relation_zipf(1 << 18, 5000, 1.5, seed=6, device="cpu")
    assert a.key.dtype == torch.int32
    assert torch.equal(a.key, b.key) and not torch.equal(a.key, c.key)
    assert int(a.key.min()) >= 1 and int(a.key.max()) <= 5000
    assert int(a.payload.abs().sum()) == 0
    # the top rank carries 1 / sum_{k<=5000} k^-1.5 = 38.70% of the rows; it
    # is a shuffled key, not key 1
    counts = torch.bincount(a.key.long())
    top = counts.argmax()
    assert abs(float(counts[top]) / (1 << 18) - 0.3870) < 0.01
    r = create_relation_zipf(4096, 500, 1.0, seed=9, device="cpu",
                             random_payload=True)
    assert int((r.payload != 0).sum()) > 4000


def test_generators_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device works")
    for call in (lambda: create_relation_zipf(64, 8, 1.5),
                 lambda: create_relation_pk(64),
                 lambda: create_relation_fk(64, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

"""The port's streaming join (ops/streamjoin.py: R on the device, S
streamed from the host in chunks) against the JAX package's on the same
numpy R and S, on the CPU, and the reference's own two tests on the
port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aqp_tpu.ops.streamjoin import streaming_join_count as jstream
from aqp_tpu.relation import Relation as JRelation
from aqp_tpu_torch.data import create_relation_fk, create_relation_pk
from aqp_tpu_torch.ops.mergejoin import merge_join_count
from aqp_tpu_torch.ops.streamjoin import (build_sorted, chunk_host_relation,
                                          probe_chunk, streaming_join_count)
from aqp_tpu_torch.relation import Relation


def test_streaming_join_matches_oracle():
    # tests/test_streamjoin.py::test_streaming_join_matches_oracle
    nr, ns = 1 << 12, 1 << 15
    r = create_relation_pk(nr, seed=301, device="cpu", random_payload=True)
    s = create_relation_fk(ns, nr, seed=302, device="cpu",
                           random_payload=True)
    ref = merge_join_count(r.key, r.payload, s.key, s.payload)
    # chunk size not dividing ns: the short tail chunk
    m, ck = streaming_join_count(
        r, chunk_host_relation(s.key.numpy(), s.payload.numpy(), 5000),
        device="cpu")
    assert m == int(ref.matches) == ns
    assert ck == int(ref.checksum)


def test_streaming_join_single_chunk_and_misses():
    # tests/test_streamjoin.py::test_streaming_join_single_chunk_and_misses
    nr = 1 << 10
    r = create_relation_pk(nr, seed=311, device="cpu")
    sk = np.arange(nr // 2, nr * 2, dtype=np.int32) + 1   # half miss
    sp = np.ones_like(sk)
    m, ck = streaming_join_count(r, [(sk, sp)], device="cpu")
    assert m == nr - nr // 2


def _inputs(seed, nr=4096, ns=20_000, big_payloads=False):
    rng = np.random.default_rng(seed)
    rk = (rng.permutation(nr) + 1).astype(np.int32)
    sk = rng.integers(-1, nr + 200, ns).astype(np.int32)   # -1s and misses
    lo = (1 << 31) - 1000 if big_payloads else -(1 << 31)
    rp = rng.integers(lo, 1 << 31, nr, dtype=np.int64).astype(np.int32)
    sp = rng.integers(lo, 1 << 31, ns, dtype=np.int64).astype(np.int32)
    return rk, rp, sk, sp


def _both(rk, rp, sk, sp, chunk):
    want = jstream(JRelation(jnp.asarray(rk), jnp.asarray(rp)),
                   chunk_host_relation(sk, sp, chunk))
    got = streaming_join_count(Relation.from_numpy(rk, rp, device="cpu"),
                               chunk_host_relation(sk, sp, chunk),
                               device="cpu")
    return got, want


@pytest.mark.parametrize("chunk", [5000, 20_000, 1 << 20],
                         ids=["5000", "n", "past-n"])
def test_equals_the_reference(chunk):
    rk, rp, sk, sp = _inputs(1)
    got, want = _both(rk, rp, sk, sp, chunk)
    assert got == want
    assert 0 < got[0] < sk.size


def test_chunks_of_one_row_equal_the_reference():
    rk, rp, sk, sp = _inputs(2, ns=600)
    got, want = _both(rk, rp, sk, sp, 1)
    assert got == want and got[0] > 0


def test_checksum_wraps_mod_2_32_as_the_references():
    rk, rp, sk, sp = _inputs(3, big_payloads=True)
    sk = np.abs(sk) % 4096 + 1                 # every row matches
    got, want = _both(rk, rp, sk, sp, 3000)
    assert got == want
    assert got[0] == sk.size
    exact = sum(int(rp[rk == k][0]) % (1 << 32) + int(p) % (1 << 32)
                for k, p in zip(sk[:100], sp[:100]))
    assert exact >= 1 << 32                     # the sum passes 2^32
    assert 0 <= got[1] < 1 << 32


def test_no_chunks_and_s_keys_of_minus_one():
    rk, rp, _, _ = _inputs(4)
    r = Relation.from_numpy(rk, rp, device="cpu")
    assert streaming_join_count(r, [], device="cpu") == (0, 0)
    assert jstream(JRelation(jnp.asarray(rk), jnp.asarray(rp)), []) == (0, 0)
    sk = np.full(1000, -1, np.int32)
    sp = np.ones(1000, np.int32)
    assert streaming_join_count(r, [(sk, sp)], device="cpu") == (0, 0)
    got, want = _both(rk, rp, sk, sp, 300)
    assert got == want == (0, 0)


def test_tensor_chunks_and_probe_chunk():
    rk, rp, sk, sp = _inputs(5)
    r = Relation.from_numpy(rk, rp, device="cpu")
    chunks = chunk_host_relation(torch.from_numpy(sk), torch.from_numpy(sp),
                                 4096)
    got = streaming_join_count(r, chunks, device="cpu")
    keys, pays = build_sorted(r.key, r.payload)
    assert torch.equal(keys, torch.sort(r.key).values)
    m, c = probe_chunk(keys, pays, torch.from_numpy(sk), torch.from_numpy(sp))
    assert (int(m), int(c)) == got
    assert m.dtype == c.dtype == torch.int64
    exact = merge_join_count(r.key, r.payload, torch.from_numpy(sk),
                             torch.from_numpy(sp))
    assert (int(exact.matches), int(exact.checksum)) == got


def test_r_on_another_device_or_s_off_the_host_raises():
    rk, rp, sk, sp = _inputs(6, ns=100)
    r = Relation.from_numpy(rk, rp, device="cpu")
    with pytest.raises(ValueError, match="not on meta"):
        streaming_join_count(r, [(sk, sp)], device="meta")
    meta = torch.zeros(100, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="on the host"):
        streaming_join_count(r, [(meta, meta)], device="cpu")

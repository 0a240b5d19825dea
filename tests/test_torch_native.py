"""The port's host generators (data/native.py, built from
native/aqp_native.cpp into aqp_tpu_torch/_build/) against the JAX
package's, which loads the repository's prebuilt native library: the same
keys, byte for byte; the generators' contract; and a raise, never a
fallback, without a compiler."""

import numpy as np
import pytest

from aqp_tpu.data import native as jnative
from aqp_tpu_torch.data import native


@pytest.fixture(scope="module")
def ref():
    assert jnative._load() is not None, (
        "the reference's native/libaqp_native.so did not load: its "
        "generators would fall back to numpy, which draws other keys")
    return jnative


@pytest.mark.parametrize("n", [1, 1000, 65_537])
def test_pk_equals_the_references(ref, n):
    got = native.gen_pk_host(n, seed=11)
    assert got.dtype == np.int32
    assert got.tobytes() == ref.gen_pk_host(n, seed=11).tobytes()


@pytest.mark.parametrize("n,maxid", [(700, 1000), (30_000, 10_000),
                                     (20_000, 10_000), (25_003, 4_096)],
                         ids=["below-maxid", "whole-blocks",
                              "two-blocks", "remainder"])
def test_fk_equals_the_references(ref, n, maxid):
    got = native.gen_fk_host(n, maxid, seed=22)
    assert got.tobytes() == ref.gen_fk_host(n, maxid, seed=22).tobytes()


@pytest.mark.parametrize("z", [0.5, 1.0, 1.5])
def test_zipf_equals_the_references(ref, z):
    got = native.gen_zipf_host(50_000, 2_000, z, seed=33)
    assert got.tobytes() == ref.gen_zipf_host(50_000, 2_000, z,
                                              seed=33).tobytes()


def test_generators_match_contract():
    # tests/test_csv_convert.py::test_native_generators_match_contract
    pk = native.gen_pk_host(10000, 1)
    assert sorted(pk.tolist()) == list(range(1, 10001))
    fk = native.gen_fk_host(25000, 10000, 2)
    assert np.array_equal(np.sort(fk[:10000]), np.arange(1, 10001))
    assert len(np.unique(fk[20000:])) == 5000
    z = native.gen_zipf_host(10000, 1000, 1.5, 3)
    assert z.min() >= 1 and z.max() <= 1000
    # other seeds, other keys
    assert not np.array_equal(native.gen_pk_host(10000, 2), pk)


def test_library_is_built_in_the_port_not_taken_from_native():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.name != "libaqp_native.so"
    native._load()
    assert path.is_file()


def test_without_a_compiler_the_call_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "fresh")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    native._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="cannot build aqp_native"):
            native.gen_pk_host(16)
        assert not list((tmp_path / "fresh").glob("*"))
        monkeypatch.setenv("CXX", "false")       # a compiler that fails
        with pytest.raises(RuntimeError, match="cannot build aqp_native"):
            native.gen_fk_host(16, 4)
        assert not list((tmp_path / "fresh").glob("*"))
    finally:
        native._load.cache_clear()

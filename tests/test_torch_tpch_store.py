"""The port's TPC-H store (the dbgen generator, the loaders, write_tables)
against the JAX package's, on the CPU.

The port's generator must write byte-identical files for the same seed;
its loaders must give the reference loaders' arrays, n_limit included;
write_tables must round-trip and write the reference writer's bytes.
Then tests/test_tpch_dbgen.py's checks on the port: the dbgen layout, the
spec-derived selectivity windows and staged == fused on the disk tables.
The file takes about 6 s on one worker alone, and 64 s beside five
other workers in the repository's full CPU test run.
"""

import numpy as np
import pytest
import torch

from aqp_tpu.data import tpch_dbgen as jdbgen
from aqp_tpu.data import tpch_loader as jloader
from aqp_tpu.queries import generate_tpch_tables as jgenerate
from aqp_tpu_torch.data import tpch_dbgen, tpch_loader
from aqp_tpu_torch.queries import filters as F
from aqp_tpu_torch.queries import fused
from aqp_tpu_torch.queries import tables as T
from aqp_tpu_torch.queries import tpch

SCALE = 0.005
LOADERS = ("load_lineitem", "load_orders", "load_customer", "load_part",
           "load_nation")


def _files(base):
    return {p.relative_to(base): p.read_bytes()
            for p in sorted(base.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same seed through both generators."""
    port = tmp_path_factory.mktemp("port")
    ref = tmp_path_factory.mktemp("ref")
    tpch_dbgen.generate(SCALE, port)
    jdbgen.generate(SCALE, ref)
    return port, ref


def test_dbgen_writes_the_references_bytes(stores):
    port, ref = stores
    got, want = _files(port), _files(ref)
    assert sorted(got) == sorted(want)
    assert len(got) == 5 + 3 + 9 + 3 + 4 + 1     # sizes and columns
    for name in want:
        assert got[name] == want[name], name


def test_dbgen_other_seed_other_bytes(tmp_path):
    tpch_dbgen.generate(0.001, tmp_path / "a", seed=1)
    tpch_dbgen.generate(0.001, tmp_path / "b", seed=2)
    a, b = (tmp_path / s / "orders.tbl.dir" / "o_orderdate.bin"
            for s in "ab")
    assert a.read_bytes() != b.read_bytes()


def test_ensure_generated_once(tmp_path):
    path = tpch_dbgen.ensure_generated(0.001, root=tmp_path)
    assert path == str(tmp_path / "scale0.001")
    marker = tmp_path / "scale0.001" / "lineitem.tbl.dir" / "size"
    before = marker.stat().st_mtime_ns
    assert tpch_dbgen.ensure_generated(0.001, root=tmp_path) == path
    assert marker.stat().st_mtime_ns == before


def _same_table(got, want):
    assert type(got).__name__ == type(want).__name__
    for k, v in want.__dict__.items():
        col = getattr(got, k)
        v = np.asarray(v)
        assert col.numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(col.numpy(), v, err_msg=k)


@pytest.mark.parametrize("loader", LOADERS)
def test_loaders_match_reference(stores, loader):
    port, _ = stores
    got = getattr(tpch_loader, loader)(port, device="cpu")
    want = getattr(jloader, loader)(port)
    _same_table(got, want)


@pytest.mark.parametrize("n_limit", [1, 1000, 10 ** 9])
def test_load_lineitem_n_limit(stores, n_limit):
    port, _ = stores
    got = tpch_loader.load_lineitem(port, n_limit=n_limit, device="cpu")
    want = jloader.load_lineitem(port, n_limit=n_limit)
    assert got.num_tuples == want.num_tuples
    _same_table(got, want)


def test_write_tables_round_trip(tmp_path):
    """The port's tables written and loaded back; and the reference's
    tables, carried across, written to the reference writer's bytes."""
    tables = T.generate_tpch_tables(scale=0.001, seed=9, device="cpu")
    names = ("lineitem", "orders", "customer", "part", "nation")
    tpch_loader.write_tables(tmp_path / "a", **dict(zip(names, tables)))
    for loader, t in zip(LOADERS, tables):
        back = getattr(tpch_loader, loader)(tmp_path / "a", device="cpu")
        for k in t.__dataclass_fields__:
            assert torch.equal(getattr(back, k), getattr(t, k)), (loader, k)
    assert tpch.tpch_q12(tables[0], tables[1]).matches == tpch.tpch_q12(
        tpch_loader.load_lineitem(tmp_path / "a", device="cpu"),
        tpch_loader.load_orders(tmp_path / "a", device="cpu")).matches
    jt = jgenerate(scale=0.001, seed=9)
    classes = (T.LineItemTable, T.OrdersTable, T.CustomerTable, T.PartTable,
               T.NationTable)
    carried = [cls.from_numpy({k: np.asarray(v) for k, v in
                               j.__dict__.items()}, device="cpu")
               for cls, j in zip(classes, jt)]
    tpch_loader.write_tables(tmp_path / "p", **dict(zip(names, carried)))
    jloader.write_tables(tmp_path / "r", **dict(zip(names, jt)))
    assert _files(tmp_path / "p") == _files(tmp_path / "r")


def _sel(mask):
    return float(mask.float().mean())


def test_dbgen_store_loads_and_queries(stores):
    """tests/test_tpch_dbgen.py on the port."""
    port, _ = stores
    l = tpch_loader.load_lineitem(port, device="cpu")
    o = tpch_loader.load_orders(port, device="cpu")
    c = tpch_loader.load_customer(port, device="cpu")
    p = tpch_loader.load_part(port, device="cpu")
    n = tpch_loader.load_nation(port, device="cpu")
    # dbgen layout facts: sparse orderkeys (8 per 32-block), dense custkey
    assert int(o.key.max()) > o.num_tuples
    assert int(c.key.max()) == c.num_tuples
    # spec-derived selectivities (generous windows; dbgen-faithful codes)
    assert 0.15 < _sel(F.q3_mask_customer(c)[0]) < 0.25
    assert 0.02 < _sel(F.q10_mask_orders(o)[0]) < 0.06
    assert 0.001 < _sel(F.q12_mask_lineitem(l)[0]) < 0.02
    assert 0.02 < _sel(F.q19_mask_lineitem(l)[0]) < 0.07
    # staged == fused on the same disk tables, Q10 too
    for staged, fuse, args, positive in (
            (tpch.tpch_q3, fused.tpch_q3_fused, (c, o, l), True),
            (tpch.tpch_q10, fused.tpch_q10_fused, (c, o, l, n), True),
            (tpch.tpch_q12, fused.tpch_q12_fused, (l, o), True),
            (tpch.tpch_q19, fused.tpch_q19_fused, (l, p), False)):
        rs = staged(*args, algorithm="RHO")
        m, ok = fuse(*args)
        assert bool(ok) and int(m) == rs.matches
        assert rs.matches > 0 or not positive

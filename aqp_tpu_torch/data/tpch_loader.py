"""TPC-H binary columnar store: loader and writer (counterpart of
aqp_tpu/data/tpch_loader.py), in the layout the reference system's CSV
converter writes (App/TpcH/CSVConvert.cpp:16-55): each table is a
directory `<table>.tbl.dir/` holding a text `size` file and one raw
little-endian `.bin` file a column:

    <t>_<key>.bin   : (u32 key, u32 payload = row id) pairs, interleaved
    dates           : u64 epoch seconds
    enums / flags   : u8 codes
    partkey/custkey : u32
    quantity        : f32

The loaders map them into the tables of queries/tables.py on `device`
(the card by default): dates narrowed to int32 (every TPC-H date is below
2^31 s), quantity to int32 (TPC-H quantities are integral), keys to
int32.  `write_tables` writes the same layout from such tables.
data/tpch_dbgen.py generates a store directly.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from aqp_tpu_torch import resolve_device
from aqp_tpu_torch.queries import tables as T

_TBL = {
    "lineitem": "lineitem.tbl.dir",
    "orders": "orders.tbl.dir",
    "customer": "customer.tbl.dir",
    "part": "part.tbl.dir",
    "nation": "nation.tbl.dir",
}


def _read_dir(base: Path, table: str):
    d = base / _TBL[table]
    n = int((d / "size").read_text().strip())
    return d, n


def _pairs(path: Path, n_file: int, n: int):
    """The first n (key, row id) pairs of a file that holds n_file."""
    a = np.fromfile(path, dtype=np.uint32)
    if a.shape[0] != 2 * n_file:
        raise ValueError(f"{path}: {a.shape[0]} words, expected "
                         f"{2 * n_file}")
    a = a.reshape(n_file, 2)[:n]
    return a[:, 0].astype(np.int32), a[:, 1].astype(np.int32)


def _col(path: Path, dtype, n: int, to=None):
    a = np.fromfile(path, dtype=dtype, count=n)
    return a if to is None else a.astype(to)


def load_lineitem(base, n_limit=None, device="cuda") -> T.LineItemTable:
    """Lineitem, its first n_limit rows when n_limit is given."""
    dev = resolve_device(device)
    d, n_file = _read_dir(Path(base), "lineitem")
    n = min(n_file, n_limit) if n_limit else n_file
    key, rowid = _pairs(d / "l_orderkey.bin", n_file, n)
    return T.LineItemTable.from_numpy(dict(
        key=key, rowid=rowid,
        shipdate=_col(d / "l_shipdate.bin", np.uint64, n, np.int32),
        commitdate=_col(d / "l_commitdate.bin", np.uint64, n, np.int32),
        receiptdate=_col(d / "l_receiptdate.bin", np.uint64, n, np.int32),
        shipmode=_col(d / "l_shipmode.bin", np.uint8, n),
        partkey=_col(d / "l_partkey.bin", np.uint32, n, np.int32),
        quantity=_col(d / "l_quantity.bin", np.float32, n, np.int32),
        shipinstruct=_col(d / "l_shipinstruct.bin", np.uint8, n),
        returnflag=_col(d / "l_returnflag.bin", np.uint8, n)), dev)


def load_orders(base, device="cuda") -> T.OrdersTable:
    dev = resolve_device(device)
    d, n = _read_dir(Path(base), "orders")
    key, rowid = _pairs(d / "o_orderkey.bin", n, n)
    return T.OrdersTable.from_numpy(dict(
        key=key, rowid=rowid,
        orderdate=_col(d / "o_orderdate.bin", np.uint64, n, np.int32),
        custkey=_col(d / "o_custkey.bin", np.uint32, n, np.int32)), dev)


def load_customer(base, device="cuda") -> T.CustomerTable:
    dev = resolve_device(device)
    d, n = _read_dir(Path(base), "customer")
    key, rowid = _pairs(d / "c_custkey.bin", n, n)
    return T.CustomerTable.from_numpy(dict(
        key=key, rowid=rowid,
        mktsegment=_col(d / "c_mktsegment.bin", np.uint8, n),
        nationkey=_col(d / "c_nationkey.bin", np.uint32, n, np.int32)), dev)


def load_part(base, device="cuda") -> T.PartTable:
    dev = resolve_device(device)
    d, n = _read_dir(Path(base), "part")
    key, rowid = _pairs(d / "p_partkey.bin", n, n)
    return T.PartTable.from_numpy(dict(
        key=key, rowid=rowid,
        brand=_col(d / "p_brand.bin", np.uint8, n),
        size=_col(d / "p_size.bin", np.uint32, n, np.int32),
        container=_col(d / "p_container.bin", np.uint8, n)), dev)


def load_nation(base, device="cuda") -> T.NationTable:
    dev = resolve_device(device)
    d, n = _read_dir(Path(base), "nation")
    key, rowid = _pairs(d / "n_nationkey.bin", n, n)
    return T.NationTable.from_numpy(dict(key=key, rowid=rowid), dev)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def write_tables(base, lineitem=None, orders=None, customer=None, part=None,
                 nation=None) -> None:
    """Write the given tables (of queries/tables.py, on any device) under
    `base` in the store's layout."""
    base = Path(base)

    def wpairs(d, name, key, rowid):
        a = np.empty((key.shape[0], 2), np.uint32)
        a[:, 0] = _np(key).astype(np.uint32)
        a[:, 1] = _np(rowid).astype(np.uint32)
        a.tofile(d / name)

    def prep(table, t):
        d = base / _TBL[table]
        d.mkdir(parents=True, exist_ok=True)
        (d / "size").write_text(str(t.num_tuples))
        return d

    def wcol(d, name, col, dtype):
        _np(col).astype(dtype).tofile(d / name)

    if lineitem is not None:
        d = prep("lineitem", lineitem)
        wpairs(d, "l_orderkey.bin", lineitem.key, lineitem.rowid)
        wcol(d, "l_shipdate.bin", lineitem.shipdate, np.uint64)
        wcol(d, "l_commitdate.bin", lineitem.commitdate, np.uint64)
        wcol(d, "l_receiptdate.bin", lineitem.receiptdate, np.uint64)
        wcol(d, "l_shipmode.bin", lineitem.shipmode, np.uint8)
        wcol(d, "l_partkey.bin", lineitem.partkey, np.uint32)
        wcol(d, "l_quantity.bin", lineitem.quantity, np.float32)
        wcol(d, "l_shipinstruct.bin", lineitem.shipinstruct, np.uint8)
        wcol(d, "l_returnflag.bin", lineitem.returnflag, np.uint8)
    if orders is not None:
        d = prep("orders", orders)
        wpairs(d, "o_orderkey.bin", orders.key, orders.rowid)
        wcol(d, "o_orderdate.bin", orders.orderdate, np.uint64)
        wcol(d, "o_custkey.bin", orders.custkey, np.uint32)
    if customer is not None:
        d = prep("customer", customer)
        wpairs(d, "c_custkey.bin", customer.key, customer.rowid)
        wcol(d, "c_mktsegment.bin", customer.mktsegment, np.uint8)
        wcol(d, "c_nationkey.bin", customer.nationkey, np.uint32)
    if part is not None:
        d = prep("part", part)
        wpairs(d, "p_partkey.bin", part.key, part.rowid)
        wcol(d, "p_brand.bin", part.brand, np.uint8)
        wcol(d, "p_size.bin", part.size, np.uint32)
        wcol(d, "p_container.bin", part.container, np.uint8)
    if nation is not None:
        d = prep("nation", nation)
        wpairs(d, "n_nationkey.bin", nation.key, nation.rowid)

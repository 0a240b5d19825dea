"""dbgen-conformant TPC-H data generator -> binary column layout
(counterpart of aqp_tpu/data/tpch_dbgen.py: the same numpy code, so the
same seed writes the same bytes).

The reference consumes dbgen-produced .tbl files converted once to raw
binary columns (App/TpcH/CSVConvert.cpp:16-55, create_binary_tables.sh);
the repo ships neither dbgen nor data.  This module generates the SAME
tables directly in the binary layout (data/tpch_loader.write_* format),
following the TPC-H specification's column distributions for every column
the four queries read:

  orders    SF*1.5M rows; o_orderkey SPARSE (8 used keys per 32-key
            group — dbgen's layout, so the build side is NOT dense and
            the real pipelines serve the joins); o_custkey uniform over
            custkeys not divisible by 3; o_orderdate uniform
            [1992-01-01, 1998-12-01 - 151 days].
  lineitem  1..7 lines per order (avg 4 → SF*6M); l_shipdate =
            orderdate + U[1,121] days, l_commitdate = orderdate +
            U[30,90], l_receiptdate = shipdate + U[1,30]; l_quantity
            U[1,50]; l_partkey uniform; l_shipmode uniform over 7 modes,
            l_shipinstruct uniform over 4; l_returnflag R/A below the
            1995-06-17 receipt horizon else N (spec 4.2.3).
  customer  SF*150k, dense custkey; c_mktsegment uniform over 5
            segments; c_nationkey uniform 0..24.
  part      SF*200k, dense partkey; p_brand Brand#MN (25 combos),
            p_container 40 combos, p_size U[1,50].

Enum codings replicate the reference's parse helpers exactly
(TpcHTypes.hpp:7-31, TpcHCommons.cpp:627-671): only query-relevant
values get nonzero codes (MAIL=1 SHIP=2 AIR=3 REG-AIR=4; DELIVER IN
PERSON=1; BUILDING=1; Brand#12/23/34=1/2/3; SM/MED/LG containers 1..12),
everything else 0 — the byte-compare filters see the same selectivities
as on dbgen data.  Lineitem is generated and appended in chunks so sf=30+
never holds the table in host memory.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

DAY = 86400
TS_1992_01_01 = 694224000
TS_1998_12_01 = 912470400
TS_1995_06_17 = 803347200  # dbgen CURRENTDATE for returnflag

_TBL = {
    "lineitem": "lineitem.tbl.dir",
    "orders": "orders.tbl.dir",
    "customer": "customer.tbl.dir",
    "part": "part.tbl.dir",
    "nation": "nation.tbl.dir",
}


def _pairs_bytes(key, rowid):
    a = np.empty((key.shape[0], 2), np.uint32)
    a[:, 0] = key.astype(np.uint32)
    a[:, 1] = rowid.astype(np.uint32)
    return a


def _sparse_orderkey(i):
    """dbgen order keys: the first 8 keys of every 32-key block."""
    return ((i // 8) * 32 + (i % 8) + 1).astype(np.uint32)


def _skip3(k):
    """k-th custkey among those not divisible by 3 (1,2,4,5,7,8,...)."""
    return (k + k // 2 + 1).astype(np.uint32)


def generate(sf: float, base: str, seed: int = 19940415,
             chunk_rows: int = 8_000_000) -> None:
    """Write sf-scaled TPC-H binary columns under `base`."""
    rng = np.random.default_rng(seed)
    base = Path(base)
    NO = int(1_500_000 * sf)
    NC = int(150_000 * sf)
    NP = int(200_000 * sf)

    # ---- orders
    d = base / _TBL["orders"]
    d.mkdir(parents=True, exist_ok=True)
    i = np.arange(NO, dtype=np.int64)
    okey = _sparse_orderkey(i)
    odate = rng.integers(TS_1992_01_01,
                         TS_1998_12_01 - 151 * DAY, NO, dtype=np.int64)
    odate -= odate % DAY
    custk = _skip3(rng.integers(0, (NC // 3) * 2, NO, dtype=np.int64))
    (d / "size").write_text(str(NO))
    _pairs_bytes(okey, i).tofile(d / "o_orderkey.bin")
    odate.astype(np.uint64).tofile(d / "o_orderdate.bin")
    custk.astype(np.uint32).tofile(d / "o_custkey.bin")

    # ---- lineitem (chunked over orders)
    d = base / _TBL["lineitem"]
    d.mkdir(parents=True, exist_ok=True)
    files = {name: open(d / name, "wb") for name in (
        "l_orderkey.bin", "l_shipdate.bin", "l_commitdate.bin",
        "l_receiptdate.bin", "l_shipmode.bin", "l_partkey.bin",
        "l_quantity.bin", "l_shipinstruct.bin", "l_returnflag.bin")}
    total = 0
    ord_chunk = max(1, chunk_rows // 4)
    for lo in range(0, NO, ord_chunk):
        hi = min(NO, lo + ord_chunk)
        nlines = rng.integers(1, 8, hi - lo)
        ok = np.repeat(okey[lo:hi], nlines)
        od = np.repeat(odate[lo:hi], nlines)
        n = ok.shape[0]
        rowid = np.arange(total, total + n, dtype=np.int64)
        ship = od + rng.integers(1, 122, n, dtype=np.int64) * DAY
        commit = od + rng.integers(30, 91, n, dtype=np.int64) * DAY
        receipt = ship + rng.integers(1, 31, n, dtype=np.int64) * DAY
        mode_raw = rng.integers(0, 7, n)
        shipmode = np.choose(np.minimum(mode_raw, 4),
                             np.array([1, 2, 3, 4, 0], np.uint8))
        instr = (rng.integers(0, 4, n) == 0).astype(np.uint8)
        old = receipt <= TS_1995_06_17
        rf = np.where(old,
                      np.where(rng.integers(0, 2, n) == 0,
                               ord("R"), ord("A")),
                      ord("N")).astype(np.uint8)
        _pairs_bytes(ok, rowid).tofile(files["l_orderkey.bin"])
        ship.astype(np.uint64).tofile(files["l_shipdate.bin"])
        commit.astype(np.uint64).tofile(files["l_commitdate.bin"])
        receipt.astype(np.uint64).tofile(files["l_receiptdate.bin"])
        shipmode.tofile(files["l_shipmode.bin"])
        rng.integers(1, NP + 1, n, dtype=np.int64).astype(
            np.uint32).tofile(files["l_partkey.bin"])
        rng.integers(1, 51, n).astype(np.float32).tofile(
            files["l_quantity.bin"])
        instr.tofile(files["l_shipinstruct.bin"])
        rf.tofile(files["l_returnflag.bin"])
        total += n
    for f in files.values():
        f.close()
    (d / "size").write_text(str(total))

    # ---- customer
    d = base / _TBL["customer"]
    d.mkdir(parents=True, exist_ok=True)
    i = np.arange(NC, dtype=np.int64)
    seg_raw = rng.integers(0, 5, NC)
    mkt = (seg_raw == 0).astype(np.uint8)  # BUILDING=1 else 0 (parse map)
    (d / "size").write_text(str(NC))
    _pairs_bytes(i + 1, i).tofile(d / "c_custkey.bin")
    mkt.tofile(d / "c_mktsegment.bin")
    rng.integers(0, 25, NC).astype(np.uint32).tofile(d / "c_nationkey.bin")

    # ---- part
    d = base / _TBL["part"]
    d.mkdir(parents=True, exist_ok=True)
    i = np.arange(NP, dtype=np.int64)
    m = rng.integers(1, 6, NP)
    nn = rng.integers(1, 6, NP)
    mn = m * 10 + nn
    brand = np.zeros(NP, np.uint8)
    brand[mn == 12] = 1
    brand[mn == 23] = 2
    brand[mn == 34] = 3
    cont_raw = rng.integers(0, 40, NP)
    # 12 coded containers (SM/MED/LG x CASE/BOX/PACK/PKG-family) out of 40
    cont = np.where(cont_raw < 12, cont_raw + 1, 0).astype(np.uint8)
    (d / "size").write_text(str(NP))
    _pairs_bytes(i + 1, i).tofile(d / "p_partkey.bin")
    brand.tofile(d / "p_brand.bin")
    rng.integers(1, 51, NP).astype(np.uint32).tofile(d / "p_size.bin")
    cont.tofile(d / "p_container.bin")

    # ---- nation
    d = base / _TBL["nation"]
    d.mkdir(parents=True, exist_ok=True)
    i = np.arange(25, dtype=np.int64)
    (d / "size").write_text("25")
    _pairs_bytes(i, i).tofile(d / "n_nationkey.bin")


def ensure_generated(sf: float, root: str = "data") -> str:
    """Generate `data/scale<sf>/` once; return the path."""
    name = f"scale{int(sf) if float(sf).is_integer() else sf}"
    base = Path(root) / name
    marker = base / "lineitem.tbl.dir" / "size"
    if not marker.exists():
        os.makedirs(base, exist_ok=True)
        generate(sf, base)
    return str(base)


if __name__ == "__main__":
    import sys

    sf = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    path = ensure_generated(sf)
    print(f"generated {path}")

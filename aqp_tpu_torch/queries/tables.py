"""TPC-H columnar tables (structure of arrays) and a seeded generator
(counterpart of aqp_tpu/queries/tables.py).

Each table is a frozen dataclass of parallel tensors on one device.  The
`key` column carries the table's key and `rowid` its row number; dates
are int32 epoch seconds (every TPC-H date is below 2^31 s) and strings
are uint8 enum codes, with the reference's codes and constants.

`from_numpy` carries a table of the JAX package across: its fields as
`{k: np.asarray(v) for k, v in t.__dict__.items()}` gives them, with the
same dtypes.  `generate_tpch_tables` draws TPC-H-shaped tables from a
`torch.Generator`: the reference's row counts, value ranges and codes, and
dense permuted primary keys.  Its bits are not the reference's
(`jax.random` cannot be reproduced here), so tests that compare the two
packages carry the reference's tables across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aqp_tpu_torch import resolve_device

# --- enum codes (the reference's TpcHTypes.hpp:7-31) ---
L_SHIPMODE_MAIL = 1
L_SHIPMODE_SHIP = 2
L_SHIPMODE_AIR = 3
L_SHIPMODE_AIR_REG = 4
L_SHIPINSTRUCT_DELIVER_IN_PERSON = 1
MKT_BUILDING = 1
P_BRAND_12 = 1
P_BRAND_23 = 2
P_BRAND_34 = 3
# containers 1..12 are the SM/MED/LG codes
L_RETURNFLAG_R = 82  # 'R'

# --- date constants, epoch seconds ---
TS_1995_01_01 = 788918400
TS_1995_03_15 = 795225600
TS_1995_03_16 = 795312000
TS_1993_10_01 = 749433600
TS_1994_01_01 = 757382400
TS_1992_01_01 = 694224000
TS_1998_12_01 = 912470400


class _Table:
    """What every table shares: its row count and the crossing from numpy."""

    @property
    def num_tuples(self) -> int:
        return self.key.shape[0]

    @property
    def device(self) -> torch.device:
        return self.key.device

    @classmethod
    def from_numpy(cls, arrays: dict, device="cuda"):
        """The table whose columns are `arrays` (a dict by field name, the
        reference's dtypes: int32 columns, uint8 codes), on `device`."""
        dev = resolve_device(device)
        cols = {}
        for f in dataclasses.fields(cls):
            a = np.ascontiguousarray(arrays[f.name])
            # torch.from_numpy shares the array's memory, which must be
            # writable (the JAX package hands out read-only views)
            if not a.flags.writeable:
                a = a.copy()
            cols[f.name] = torch.from_numpy(a).to(dev)
        return cls(**cols)


@dataclasses.dataclass(frozen=True)
class LineItemTable(_Table):
    key: torch.Tensor       # l_orderkey
    rowid: torch.Tensor
    shipdate: torch.Tensor  # int32 epoch seconds
    commitdate: torch.Tensor
    receiptdate: torch.Tensor
    shipmode: torch.Tensor  # uint8 codes
    partkey: torch.Tensor
    quantity: torch.Tensor  # int32 (TPC-H quantities are integral 1..50)
    shipinstruct: torch.Tensor
    returnflag: torch.Tensor


@dataclasses.dataclass(frozen=True)
class OrdersTable(_Table):
    key: torch.Tensor  # o_orderkey
    rowid: torch.Tensor
    orderdate: torch.Tensor
    custkey: torch.Tensor


@dataclasses.dataclass(frozen=True)
class CustomerTable(_Table):
    key: torch.Tensor  # c_custkey
    rowid: torch.Tensor
    mktsegment: torch.Tensor
    nationkey: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PartTable(_Table):
    key: torch.Tensor  # p_partkey
    rowid: torch.Tensor
    brand: torch.Tensor
    size: torch.Tensor
    container: torch.Tensor


@dataclasses.dataclass(frozen=True)
class NationTable(_Table):
    key: torch.Tensor  # n_nationkey
    rowid: torch.Tensor


def generate_tpch_tables(scale: float = 0.01, seed: int = 42,
                         device="cuda"):
    """Seeded TPC-H-shaped tables at `scale` (scale 1 -> 6M lineitems), on
    `device`.  Returns (lineitem, orders, customer, part, nation).

    Orderkeys are dense {1..NO} in a random order; custkey and partkey are
    uniform foreign keys into their dense permuted primary keys: the
    reference's join topology, row counts, value ranges and enum codes."""
    dev = resolve_device(device)
    NL = max(64, int(6_001_215 * scale))
    NO = max(32, int(1_500_000 * scale))
    NC = max(16, int(150_000 * scale))
    NP = max(16, int(200_000 * scale))
    NN = 25
    gen = torch.Generator(device=dev).manual_seed(seed)

    def u(n, lo, hi, dtype=torch.int32):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int32).to(dtype)

    def perm1(n):
        return (torch.randperm(n, generator=gen, device=dev) + 1).to(
            torch.int32)

    def rows(n):
        return torch.arange(n, dtype=torch.int32, device=dev)

    u8 = torch.uint8
    lineitem = LineItemTable(
        key=u(NL, 1, NO + 1),
        rowid=rows(NL),
        shipdate=u(NL, TS_1992_01_01, TS_1998_12_01),
        commitdate=u(NL, TS_1992_01_01, TS_1998_12_01),
        receiptdate=u(NL, TS_1992_01_01, TS_1998_12_01),
        shipmode=u(NL, 1, 8, u8),            # 7 modes, codes 1..7
        partkey=u(NL, 1, NP + 1),
        quantity=u(NL, 1, 51),
        shipinstruct=u(NL, 1, 5, u8),        # 4 instruction codes
        returnflag=torch.tensor([65, 78, 82], dtype=u8, device=dev)[
            u(NL, 0, 3).long()],
    )
    orders = OrdersTable(
        key=perm1(NO),
        rowid=rows(NO),
        orderdate=u(NO, TS_1992_01_01, TS_1998_12_01),
        custkey=u(NO, 1, NC + 1),
    )
    customer = CustomerTable(
        key=perm1(NC),
        rowid=rows(NC),
        mktsegment=u(NC, 1, 6, u8),          # 5 segments
        nationkey=u(NC, 0, NN),
    )
    part = PartTable(
        key=perm1(NP),
        rowid=rows(NP),
        brand=u(NP, 1, 6, u8),               # brands 1..5 (12/23/34 + 2)
        size=u(NP, 1, 51),
        container=u(NP, 1, 17, u8),          # 16 containers
    )
    nation = NationTable(key=rows(NN), rowid=rows(NN))
    return lineitem, orders, customer, part, nation

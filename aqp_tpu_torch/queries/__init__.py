from aqp_tpu_torch.queries.tables import (
    CustomerTable,
    LineItemTable,
    NationTable,
    OrdersTable,
    PartTable,
    generate_tpch_tables,
)
from aqp_tpu_torch.queries.tpch import tpch_q3, tpch_q10, tpch_q12, tpch_q19

__all__ = [
    "LineItemTable",
    "OrdersTable",
    "CustomerTable",
    "PartTable",
    "NationTable",
    "generate_tpch_tables",
    "tpch_q3",
    "tpch_q10",
    "tpch_q12",
    "tpch_q19",
]

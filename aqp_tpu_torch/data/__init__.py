from aqp_tpu_torch.data.generator import (  # noqa: F401
    create_relation_fk,
    create_relation_fk_sel,
    create_relation_pk,
    create_relation_zipf,
    oracle_matches_fk,
)

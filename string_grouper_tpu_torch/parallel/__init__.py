"""Sharding layers: the single-controller mesh tier (mesh construction,
sharded encode and top-n matching, the collective TF-IDF reductions) and
the multi-process tiers over ``torch.distributed`` ranks."""

from .distributed import (
    Mesh,
    distributed_df_counts,
    distributed_topn_cosine_matches,
    make_mesh,
    replicated_idf,
    sharded_fit_transform,
)
from .multihost import (
    multihost_encode_shard,
    multihost_fit_pairs,
    multihost_match_shard,
    multihost_sharded_fit_pairs,
)

__all__ = [
    "Mesh",
    "distributed_df_counts",
    "distributed_topn_cosine_matches",
    "make_mesh",
    "multihost_encode_shard",
    "multihost_fit_pairs",
    "multihost_match_shard",
    "multihost_sharded_fit_pairs",
    "replicated_idf",
    "sharded_fit_transform",
]

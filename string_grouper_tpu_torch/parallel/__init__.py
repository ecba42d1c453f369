"""Multi-device sharding layer: mesh construction, sharded encode and
top-n matching, and the collective TF-IDF reductions (single controller)."""

from .distributed import (
    Mesh,
    distributed_df_counts,
    distributed_topn_cosine_matches,
    make_mesh,
    replicated_idf,
    sharded_fit_transform,
)

__all__ = [
    "Mesh",
    "distributed_df_counts",
    "distributed_topn_cosine_matches",
    "make_mesh",
    "replicated_idf",
    "sharded_fit_transform",
]

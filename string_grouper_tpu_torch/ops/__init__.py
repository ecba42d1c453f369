from .matcher import (
    MatchPairs,
    apply_self_join_fixups,
    order_like_reference_csr,
    topn_cosine_matches,
)
from .hashing import hashed_projection
from .rescore import rescore_pairs_fp64

__all__ = [
    "MatchPairs",
    "apply_self_join_fixups",
    "order_like_reference_csr",
    "topn_cosine_matches",
    "hashed_projection",
    "rescore_pairs_fp64",
]

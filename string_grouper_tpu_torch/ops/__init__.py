from .matcher import (
    MatchPairs,
    apply_self_join_fixups,
    order_like_reference_csr,
    topn_cosine_matches,
)
from .rescore import rescore_pairs_fp64

__all__ = [
    "MatchPairs",
    "apply_self_join_fixups",
    "order_like_reference_csr",
    "topn_cosine_matches",
    "rescore_pairs_fp64",
]

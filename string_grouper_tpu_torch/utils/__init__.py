from .group_reps import (
    new_group_rep_by_completeness,
    new_group_rep_by_earliest_timestamp,
    new_group_rep_by_highest_weight,
)
from .profiling import PhaseTimings

__all__ = [
    "PhaseTimings",
    "new_group_rep_by_completeness",
    "new_group_rep_by_earliest_timestamp",
    "new_group_rep_by_highest_weight",
]

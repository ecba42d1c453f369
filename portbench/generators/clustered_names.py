"""Near-duplicate clusters of company names: ``max(1, int(n * base_share))``
base names, each name one of them drawn uniformly, with a legal suffix and
on a share one mutation (``lib/names.py``).  With the parameters of
``traffic/clustered.json`` and the seed 42 this is the port's synthetic
663k corpus, name for name."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from portbench.lib import names


def generate(n: int, rng: np.random.Generator, *, base_share: float,
              two_stem_share: float, mutation_cuts: Sequence[float]) -> List[str]:
    n_bases = max(1, int(n * base_share))
    base_names = names.bases(rng, n_bases, two_stem_share)
    return names.dress(rng, base_names, rng.integers(0, n_bases, size=n), mutation_cuts)

"""A traffic mix's input lists and the order each call hands them over.

A mix is a data file, ``traffic/<mix>.json``: for every input list the
configuration sizes, the name of its generator, the generator's
parameters and a ``corpus_seed``.  A generator is a file of its own,
``generators/<name>.py``, whose ``generate(n, rng, **params)`` returns
``n`` strings; so a later change adds a mix of a known kind as one data
file, and a new kind as one more generator file, with no file here edited.

The timed lists are drawn from each list's ``corpus_seed``, the same for
every run seed: the work of a call follows the corpus (the 663k
self-join's escalated rows range from 23,000 to 40,000 a call between
corpora of one law on the H100), and every run has to do the same work.  The run's seed draws the order: every
call takes a fresh permutation of each list, outside the timed call, so
that no call repeats another's input.  The run's seed also draws the
check lists, a corpus of the same law and sizes (each list on a stream of
its own), on which one more call, outside the window, is judged: so every
run checks the program on a corpus of its own.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from .spec import HERE, load_module

#: seed streams of the check lists and of the per-call permutations
_LIST_STREAM = 1_000_001
_PERM_STREAM = 1_000_003


def generator(name: str):
    path = HERE / "generators" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no generator {name!r} ({path})")
    return load_module(path, "generator")


class Traffic:
    def __init__(self, spec: dict, sizes: Dict[str, int], seed: int):
        if set(spec["lists"]) != set(sizes):
            raise ValueError(
                f"traffic lists {sorted(spec['lists'])} differ from the "
                f"configuration's sizes {sorted(sizes)}"
            )
        self.spec = spec
        self.sizes = sizes
        self.seed = int(seed)
        self.lists = self._draw(lambda i, p: np.random.default_rng(int(p["corpus_seed"])))

    def _draw(self, rng_of: Callable[[int, dict], np.random.Generator]):
        out: Dict[str, np.ndarray] = {}
        for i, (name, p) in enumerate(self.spec["lists"].items()):
            params = {k: v for k, v in p.items() if k not in ("generator", "corpus_seed")}
            gen = generator(p["generator"])
            out[name] = np.array(gen.generate(int(self.sizes[name]), rng_of(i, p), **params),
                                 dtype=object)
        return out

    def check_lists(self) -> Dict[str, np.ndarray]:
        """Lists of the same law and sizes as the timed ones, drawn from the
        run's seed."""
        return self._draw(lambda i, p: np.random.default_rng([self.seed, _LIST_STREAM, i]))

    def order(self, call: int) -> Dict[str, np.ndarray]:
        """Position -> list index of every list in call ``call`` (0 is the
        warm-up call of set-up)."""
        return {name: np.random.default_rng([self.seed, _PERM_STREAM, call, i])
                .permutation(len(arr)) for i, (name, arr) in enumerate(self.lists.items())}

"""The parts of a seeded company-name list, for the generators under
``generators/``: the lexicon, the base names drawn from it, and the names
dressed from the bases (a legal suffix, and one mutation on a share).

A frozen copy of the synthetic corpus that stands in for the 663,000 SEC
EDGAR company names of string_grouper's published benchmark (the list is
not redistributable): ``generators/clustered_names.py`` with the
parameters of ``traffic/clustered.json`` yields, name for name, the
corpus of the port's ``utils/synthetic.synthetic_company_names``.  The
copy lives here because the program may change and the yardstick may not
(a test pins a checksum).  A generator of another shape (a skewed base
popularity, a lexicon of its own) is a new file under ``generators/``
that imports these parts.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

STEMS = [
    "advanced", "allied", "american", "apex", "atlantic", "atlas", "axis",
    "beacon", "blue", "bridge", "capital", "cascade", "central", "citadel",
    "coastal", "crown", "crystal", "delta", "diamond", "eagle", "east",
    "electric", "empire", "federal", "first", "frontier", "fusion", "general",
    "global", "golden", "grand", "great", "harbor", "heritage", "horizon",
    "imperial", "integrated", "international", "iron", "keystone", "liberty",
    "lone", "metro", "midland", "national", "north", "northern", "oak",
    "pacific", "paramount", "peak", "phoenix", "pinnacle", "pioneer",
    "platinum", "premier", "prime", "quantum", "regal", "river", "royal",
    "sierra", "silver", "south", "southern", "sterling", "stellar", "summit",
    "superior", "titan", "tri-state", "union", "united", "universal",
    "valley", "vanguard", "vertex", "western", "white", "world", "zenith",
]
MIDS = [
    "aero", "agri", "bio", "build", "chem", "com", "data", "dyn", "energy",
    "engineering", "equity", "finance", "food", "gas", "health", "home",
    "industrial", "info", "insurance", "invest", "land", "life", "machine",
    "marine", "media", "medical", "metal", "mining", "motor", "oil",
    "pharma", "power", "print", "property", "rail", "realty", "resource",
    "retail", "semiconductor", "service", "software", "steel", "tech",
    "telecom", "textile", "timber", "trade", "transport", "trust", "water",
]
KINDS = [
    "industries", "holdings", "partners", "systems", "solutions", "group",
    "enterprises", "associates", "ventures", "brands", "labs",
    "international", "corporation", "company", "works", "networks",
]
SUFFIXES = [
    "inc", "inc.", "incorporated", "llc", "l.l.c.", "ltd", "ltd.", "limited",
    "corp", "corp.", "co", "co.", "plc", "lp", "l.p.", "s.a.", "n.v.", "",
]


def bases(rng: np.random.Generator, n_bases: int, two_stem_share: float) -> List[str]:
    """``n_bases`` base names "stem [stem] mid kind"; a share
    ``two_stem_share`` of them carries a second stem."""
    s = rng.integers(0, len(STEMS), size=n_bases)
    m = rng.integers(0, len(MIDS), size=n_bases)
    k = rng.integers(0, len(KINDS), size=n_bases)
    extra = rng.integers(0, len(STEMS), size=n_bases)
    two_stem = rng.random(n_bases) < two_stem_share
    return [
        (
            f"{STEMS[s[i]]} {STEMS[extra[i]]} {MIDS[m[i]]} {KINDS[k[i]]}"
            if two_stem[i]
            else f"{STEMS[s[i]]} {MIDS[m[i]]} {KINDS[k[i]]}"
        )
        for i in range(n_bases)
    ]


def dress(rng: np.random.Generator, base_names: Sequence[str], base_idx: np.ndarray,
          mutation_cuts: Sequence[float]) -> List[str]:
    """One name per entry of ``base_idx``: its base with a legal suffix,
    and one mutation by one uniform draw against the cumulative cuts
    ``mutation_cuts`` (drop one character, double one character, title
    case)."""
    drop_cut, double_cut, title_cut = (float(c) for c in mutation_cuts)
    n = len(base_idx)
    suffix_idx = rng.integers(0, len(SUFFIXES), size=n)
    mutate = rng.random(n)
    out = []
    for i in range(n):
        name = base_names[base_idx[i]]
        suf = SUFFIXES[suffix_idx[i]]
        if suf:
            name = f"{name} {suf}"
        r = mutate[i]
        if r < drop_cut:
            pos = int(r * 1e6) % len(name)
            name = name[:pos] + name[pos + 1:]
        elif r < double_cut:
            pos = int(r * 1e6) % len(name)
            name = name[:pos] + name[pos] + name[pos:]
        elif r < title_cut:
            name = name.title()
        out.append(name)
    return out

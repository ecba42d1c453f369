"""Deterministic synthetic company-name corpus (numpy only): the stand-in
for the reference's 663,000 SEC EDGAR names (its published benchmark,
reference README.md:43-56), element-for-element the corpus of the JAX
package's ``bench.synthetic_company_names``."""

from __future__ import annotations

from typing import List

import numpy as np

_STEMS = [
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
_MIDS = [
    "aero", "agri", "bio", "build", "chem", "com", "data", "dyn", "energy",
    "engineering", "equity", "finance", "food", "gas", "health", "home",
    "industrial", "info", "insurance", "invest", "land", "life", "machine",
    "marine", "media", "medical", "metal", "mining", "motor", "oil",
    "pharma", "power", "print", "property", "rail", "realty", "resource",
    "retail", "semiconductor", "service", "software", "steel", "tech",
    "telecom", "textile", "timber", "trade", "transport", "trust", "water",
]
_KINDS = [
    "industries", "holdings", "partners", "systems", "solutions", "group",
    "enterprises", "associates", "ventures", "brands", "labs",
    "international", "corporation", "company", "works", "networks",
]
_SUFFIXES = [
    "inc", "inc.", "incorporated", "llc", "l.l.c.", "ltd", "ltd.", "limited",
    "corp", "corp.", "co", "co.", "plc", "lp", "l.p.", "s.a.", "n.v.", "",
]


def synthetic_company_names(n: int, seed: int = 42) -> List[str]:
    """``n`` company names in near-duplicate clusters (same base name,
    differing legal suffix / punctuation / small typos)."""
    rng = np.random.default_rng(seed)
    n_bases = max(1, int(n * 0.55))
    s = rng.integers(0, len(_STEMS), size=n_bases)
    m = rng.integers(0, len(_MIDS), size=n_bases)
    k = rng.integers(0, len(_KINDS), size=n_bases)
    extra = rng.integers(0, len(_STEMS), size=n_bases)
    two_stem = rng.random(n_bases) < 0.35
    bases = [
        (
            f"{_STEMS[s[i]]} {_STEMS[extra[i]]} {_MIDS[m[i]]} {_KINDS[k[i]]}"
            if two_stem[i]
            else f"{_STEMS[s[i]]} {_MIDS[m[i]]} {_KINDS[k[i]]}"
        )
        for i in range(n_bases)
    ]
    base_idx = rng.integers(0, n_bases, size=n)
    suffix_idx = rng.integers(0, len(_SUFFIXES), size=n)
    mutate = rng.random(n)
    out = []
    for i in range(n):
        name = bases[base_idx[i]]
        suf = _SUFFIXES[suffix_idx[i]]
        if suf:
            name = f"{name} {suf}"
        r = mutate[i]
        if r < 0.15:  # drop one character
            pos = int(r * 1e6) % len(name)
            name = name[:pos] + name[pos + 1 :]
        elif r < 0.25:  # duplicate one character
            pos = int(r * 1e6) % len(name)
            name = name[:pos] + name[pos] + name[pos:]
        elif r < 0.32:  # uppercase style variant
            name = name.title()
        out.append(name)
    return out

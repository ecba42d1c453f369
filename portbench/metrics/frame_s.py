"""frame_s: everything of a call after the match (the matches list, the
output frame: ``get_matches`` / ``get_groups``), as the call's wall less
``encode`` and ``match``; mean over the window's calls."""


def read(run):
    rest = [c["wall"] - c["timings"]["encode"] - c["timings"]["match"]
            for c in run.calls if "encode" in c["timings"] and "match" in c["timings"]]
    return sum(rest) / len(rest) if rest else None

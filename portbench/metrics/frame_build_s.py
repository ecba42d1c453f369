"""frame_build_s: the matches list and the output frame as the program's
own spans time them (``assemble`` + ``frame``: ranges ``sg.assemble`` and
``sg.frame``), mean over the window's calls that have ``frame``; the span
beside the outside-measured ``frame_s``."""


def read(run):
    per_call = [c["timings"].get("assemble", 0.0) + c["timings"]["frame"]
                for c in run.calls if "frame" in c["timings"]]
    return sum(per_call) / len(per_call) if per_call else None

#!/usr/bin/env python3
"""Which kernels of another checkout this checkout compiles to the same
machine code: the check that a change to the CUDA sources left a build
as it was.

Run from the repository root on a machine with nvcc:

    python tools/sass_diff.py OTHER_CHECKOUT [NAME ...]

For each kernel library NAME (default: the five on the TMA/wgmma scan,
csrc/p1_scan_sm90.cuh), both checkouts' csrc/NAME.cu are compiled to a
cubin with the flags of ops/_build.py (one nvcc per source, all started
together) and disassembled with cuobjdump -sass.  For every kernel of
OTHER_CHECKOUT the script prints its instruction count and the kernel of
this checkout whose instructions are the same, addresses and encodings
aside, or "none".  Kernel names may differ (a template parameter added
with a default changes the mangled name); the code is what is compared.
The last line is one JSON object {NAME: {other kernel: this kernel or
null}}.
"""

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from string_grouper_tpu_torch.ops import _build  # noqa: E402

SCAN_LIBS = ("p1_fused_closed2", "p1_fused_chain", "p1_tri_fused",
             "p1_mm_floor", "p1_closed2_variant")
CSRC = Path("string_grouper_tpu_torch") / "csrc"


def sass(cubin: Path) -> dict:
    """Kernel name -> its instructions (comments, addresses and encodings
    removed), from cuobjdump -sass."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and "/*" in line:
            ins = re.sub(r"/\*.*?\*/", "", line).strip()
            if ins:
                out[name].append(ins)
    return out


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[0]).resolve()
    names = argv[1:] or SCAN_LIBS
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for n in names:
            for side, root in (("this", ROOT), ("other", other)):
                cubin = Path(tmp) / f"{side}_{n}.cubin"
                procs[side, n] = (cubin, subprocess.Popen(
                    [_build._nvcc(), *flags, "-cubin", "-o", str(cubin),
                     str(root / CSRC / f"{n}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        code = {}
        for key, (cubin, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {key}:\n{log.decode(errors='replace')}")
            code[key] = sass(cubin)
    result = {}
    for n in names:
        mine = code["this", n]
        result[n] = {}
        for kernel, ins in code["other", n].items():
            same = next((k for k, v in mine.items() if v == ins), None)
            result[n][kernel] = same
            print(f"{n}: {kernel} ({len(ins)} instructions): "
                  f"{'same code as ' + same if same else 'none of this checkout is the same'}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

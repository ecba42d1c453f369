"""Running the harness from the tests: in a subprocess (a clean interpreter,
as a benchmark run starts) or in this process (to break the program
underneath it)."""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
RUN = ROOT / "portbench" / "run.py"


def run_subprocess(args, root: Path = ROOT, cwd: Path = ROOT, extra_path=None,
                   timeout=600):
    env = dict(os.environ)
    if extra_path is not None:
        env["PYTHONPATH"] = str(extra_path)
    else:
        env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(root / "portbench" / "run.py"), *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def last_json(stdout: str):
    """The last line of standard output as JSON; None when it is none."""
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def run_in_process(args):
    """``run.main(args)`` here; returns (exit code, last JSON line or None,
    standard error)."""
    sys.path.insert(0, str(RUN.parent))
    try:
        import run as harness
    finally:
        sys.path.remove(str(RUN.parent))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(args)
    return rc, last_json(out.getvalue()), err.getvalue()

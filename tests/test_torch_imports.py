"""The port stands alone: importing ``string_grouper_tpu_torch`` pulls in
neither JAX nor the JAX package, no module of the port (nor chip_smoke.py)
imports either, and the default device without a GPU raises instead of
quietly running on the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pandas as pd
import pytest
import torch

import string_grouper_tpu_torch as sgt

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "string_grouper_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "string_grouper_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_import_leaves_jax_and_jax_package_out():
    code = (
        "import sys, string_grouper_tpu_torch, string_grouper_tpu_torch.ops.kernels\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'string_grouper_tpu')]\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, check=True, timeout=120,
    )
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_forbidden_import(path):
    bad = [m for m in _imported_roots(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_default_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    s = pd.Series(["Hyper Startup Inc.", "Hyper-Startup Inc.", "Mega Corp."])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sgt.match_strings(s)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        sgt.StringGrouper(s, device="cuda")
    for call in (
        lambda: sgt.group_similar_strings(s),
        lambda: sgt.match_most_similar(s, s[:2]),
        lambda: sgt.compute_pairwise_similarities(s, s),
        lambda: sgt.StringGrouper(s, device="cpu").update_options(device="cuda"),
        lambda: sgt.StringGrouper(s, device="cpu").group_similar_strings(
            s, device="cuda"),
    ):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()


def test_bad_device_value_raises():
    s = pd.Series(["a b c", "a b d"])
    with pytest.raises(ValueError, match="device"):
        sgt.match_strings(s, device="tpu")

"""Process state the port's matcher reads and writes, on the CPU.

* The caller's float32 matmul setting (TF32 on or off, in the legacy or
  the per-backend API) is what it was after any ``match_strings``: the
  torch-op scan runs its products in full float32 and restores the
  setting (``ops.kernels.ieee_f32_matmul``), as JAX's scan leaves no
  process state behind; the frame stays the JAX package's.
* ``ops.matcher.LAST_STATS`` mirrors the stats of the last matcher fit
  (string_grouper_tpu/ops/matcher.py:82-87), and the engine reads it when
  a result carries no stats (string_grouper_tpu/engine.py:337-339).
* ``StringGrouper.timings`` holds the JAX package's keys with the float
  match stats rounded to 3 places, as JAX's engine rounds them, on every
  fit tier; ``LAST_STATS`` keeps the matcher's unrounded values.
"""

import os
import re
import sys
import threading

import pandas as pd
import pytest
import torch

import string_grouper_tpu as sgj
import string_grouper_tpu_torch as sgt
from string_grouper_tpu.config import StringGrouperConfig as JConfig
from string_grouper_tpu.corpus.tfidf import TfidfEncoder as JEncoder
from string_grouper_tpu.ops import matcher as JM
from string_grouper_tpu_torch import engine as TE
from string_grouper_tpu_torch.config import StringGrouperConfig as TConfig
from string_grouper_tpu_torch.corpus import TfidfEncoder as TEncoder
from string_grouper_tpu_torch.ops import kernels as K
from string_grouper_tpu_torch.ops import matcher as TM

from test_matcher import random_names

MATMUL = torch.backends.cuda.matmul


def _state():
    """What a caller reads back: the legacy flag and precision where the
    legacy getters answer, and the per-backend setting."""
    try:
        legacy = (MATMUL.allow_tf32, torch.get_float32_matmul_precision())
    except RuntimeError:  # the setting was made through the per-backend API
        legacy = None
    return legacy, MATMUL.fp32_precision


@pytest.fixture
def restore_precision():
    yield
    torch.set_float32_matmul_precision("highest")
    MATMUL.fp32_precision = "none"


SETTINGS = {
    "allow_tf32": lambda: setattr(MATMUL, "allow_tf32", True),
    "precision_high": lambda: torch.set_float32_matmul_precision("high"),
    "precision_medium": lambda: torch.set_float32_matmul_precision("medium"),
    "backend_tf32": lambda: setattr(MATMUL, "fp32_precision", "tf32"),
    "default": lambda: None,
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_match_leaves_the_matmul_setting_as_found(setting, restore_precision):
    names = pd.Series(random_names(400, seed=5))
    want = sgj.match_strings(names, min_similarity=0.6)
    SETTINGS[setting]()
    before = _state()
    got = sgt.match_strings(names, min_similarity=0.6, device="cpu")
    assert _state() == before
    if setting == "allow_tf32":
        assert before == ((True, "high"), "tf32")
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_ieee_block_sets_full_float32_and_restores_once(restore_precision):
    MATMUL.allow_tf32 = True
    inside, entered, leave = [], threading.Event(), threading.Event()

    def other():
        with K.ieee_f32_matmul():
            entered.set()
            leave.wait(30)
            inside.append(torch.get_float32_matmul_precision())

    with K.ieee_f32_matmul():
        inside.append(torch.get_float32_matmul_precision())
        t = threading.Thread(target=other)
        t.start()
        assert entered.wait(30)
    # the other thread's block is still open: the setting stays full f32
    inside.append(torch.get_float32_matmul_precision())
    leave.set()
    t.join(30)
    assert inside == ["highest", "highest", "highest"]
    assert MATMUL.allow_tf32 and torch.get_float32_matmul_precision() == "high"


def test_ieee_blocks_on_many_threads_keep_and_restore_the_setting(restore_precision):
    """More threads than cores entering and leaving blocks at a short
    switch interval: inside every block the setting is full float32, and
    the caller's comes back once all have left."""
    torch.set_float32_matmul_precision("medium")
    seen, errors = set(), []

    def worker():
        try:
            for _ in range(200):
                with K.ieee_f32_matmul():
                    seen.add(torch.get_float32_matmul_precision())
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert seen == {"highest"}
    assert torch.get_float32_matmul_precision() == "medium" and MATMUL.allow_tf32


def test_last_stats_mirrors_the_fit_in_both_packages():
    names = random_names(300, seed=1)
    jp = JM.topn_cosine_matches(JEncoder(JConfig()).fit_transform(names), None, 0.6, 10)
    tp = TM.topn_cosine_matches(TEncoder(TConfig()).fit_transform(names), None, 0.6, 10,
                                device="cpu")
    assert JM.LAST_STATS is jp.stats and TM.LAST_STATS is tp.stats
    assert set(jp.stats) <= set(tp.stats)  # the port adds its esc_rows_* counters
    assert tp.stats["rounds"] == jp.stats["rounds"]
    assert tp.stats["pairs_scored"] == jp.stats["pairs_scored"]


def test_engine_reads_last_stats_when_pairs_carry_none(monkeypatch):
    names = pd.Series(random_names(300, seed=2))
    real = TE.topn_cosine_matches
    seen = {}

    def bare(*args, **kw):
        pairs = real(*args, **kw)
        seen["stats"] = pairs.stats
        pairs.stats = None
        return pairs

    monkeypatch.setattr(TE, "topn_cosine_matches", bare)
    sg = sgt.StringGrouper(names, min_similarity=0.6, device="cpu").fit()
    got = {k[len("match."):]: v for k, v in sg.timings.seconds.items()
           if k.startswith("match.")}
    assert seen["stats"] is TM.LAST_STATS
    # timings keeps float stats to 3 places (as the JAX engine); LAST_STATS
    # keeps them as the matcher made them
    assert got == {k: round(v, 3) if isinstance(v, float) else v
                   for k, v in TM.LAST_STATS.items()}


#: ``timings`` keys only the port has: its escalation counters per rung and
#: of the rows run on ``p1_fused_topk``, the rows its native duplicate
#: grouping grouped, the calling thread's wait for the scoring worker, on
#: the replicated tier each rank's matcher stats, and on the sharded tier
#: its collectives' and ring's seconds and bytes, the world and the slots
PORT_ONLY = re.compile(
    r"match\.(mh_local_\w+|esc_rows_r\d+_kt\d+|esc_kernel_rows"
    r"|collapse_native_rows|rescore_wait"
    r"|mh_(replicate|exchange|ring)_bytes|mh_(replicate|exchange|ring_bcast)_s"
    r"|mh_world|mh_slots)")


@pytest.mark.parametrize("tier", [None, True, "sharded"])
def test_timings_keys_and_rounding_as_jax(tier):
    """The same fit in both packages: the JAX package's ``timings`` keys
    (the port's adds only PORT_ONLY), and every float match stat rounded
    to 3 places in both (string_grouper_tpu/engine.py:342-343, :421-422),
    on the single-process path and on both multi-process tiers."""
    names = pd.Series(random_names(300, seed=5))
    kw = {} if tier is None else dict(multihost=tier)
    t = sgt.StringGrouper(names, min_similarity=0.6, device="cpu", **kw).fit()
    j = sgj.StringGrouper(names, min_similarity=0.6, **kw).fit()
    t_sec, j_sec = t.timings.seconds, j.timings.seconds
    assert set(j_sec) <= set(t_sec)
    assert all(PORT_ONLY.fullmatch(k) for k in set(t_sec) - set(j_sec)), \
        set(t_sec) - set(j_sec)
    for secs in (t_sec, j_sec):
        stats = {k: v for k, v in secs.items() if k.startswith("match.")}
        assert any(isinstance(v, float) for v in stats.values())
        for k, v in stats.items():
            assert not isinstance(v, float) or round(v, 3) == v, (k, v)

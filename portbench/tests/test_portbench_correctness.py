"""What decides ``correct`` has to fail when it should.

The control: the program on its own float32 path (``--control f32``), one
precision below the configurations' float64, comes out not correct.  And a
run with the timed path broken underneath (the faults a cell can have: an
answer altered where it is produced, half of the rows left out) comes out
not correct.  The faults are planted in the port's modules in this process
and the harness is driven in it (``--rehearse-cpu``: no look for a card)."""

import numpy as np
import pytest

from helpers import last_json, run_in_process, run_subprocess

SELF = ["--workload", "edgar_dedup.clustered", "--seconds", "1", "--trace", "0",
        "--rehearse-cpu", "1500"]
# 20,000 names a list: enough of the new names have a master at 0.8 or above
LINK = ["--workload", "edgar_link.new100k", "--seconds", "1", "--trace", "0",
        "--rehearse-cpu", "20000"]


@pytest.mark.parametrize("args", [SELF, LINK], ids=["self", "link"])
def test_float32_control_is_not_correct(args):
    r = run_subprocess(args + ["--seed", "3000000001", "--control", "f32"])
    assert r.returncode == 0, r.stderr[-3000:]
    res = last_json(r.stdout)
    assert res["correct"] is False
    gap = res["checks"]["sim_gap"]
    assert gap["value"] > 100 * gap["limit"]


def _sound(args, seed):
    rc, res, err = run_in_process(args + ["--seed", str(seed)])
    assert rc == 0, err[-3000:]
    return res


def _altered_similarity(monkeypatch):
    from string_grouper_tpu_torch.ops import matcher

    real = matcher.rescore_pairs_fp64

    def rescore(*a, **k):
        out = real(*a, **k)
        out[::3] += 1e-6
        return out
    monkeypatch.setattr(matcher, "rescore_pairs_fp64", rescore)


def _half_rows_left_out(monkeypatch):
    from string_grouper_tpu_torch.ops import matcher

    real = matcher.apply_self_join_fixups

    def fixups(pairs, n):
        out = real(pairs, n)
        keep = (out.rows % 2 == 0) | (out.rows == out.cols)
        return matcher.MatchPairs(rows=out.rows[keep], cols=out.cols[keep],
                                  sims=out.sims[keep],
                                  true_max_n_matches=out.true_max_n_matches)
    monkeypatch.setattr(matcher, "apply_self_join_fixups", fixups)


def _half_new_names_left_out(monkeypatch):
    from string_grouper_tpu_torch.ops import matcher

    real = matcher.order_like_reference_csr

    def order(pairs):
        out = real(pairs)
        keep = out.cols % 2 == 0
        return matcher.MatchPairs(rows=out.rows[keep], cols=out.cols[keep],
                                  sims=out.sims[keep],
                                  true_max_n_matches=out.true_max_n_matches)
    monkeypatch.setattr(matcher, "order_like_reference_csr", order)


def _altered_nearest(monkeypatch):
    from string_grouper_tpu_torch import engine

    real = engine.assemble_nearest_matches

    def assemble(master, *a, **k):
        out = real(master, *a, **k)
        idx = out["most_similar_index"].to_numpy(dtype=np.float64)
        hit = np.flatnonzero(~np.isnan(idx))
        out.iloc[hit, 0] = (idx[hit] + 1) % len(master)
        return out
    monkeypatch.setattr(engine, "assemble_nearest_matches", assemble)


@pytest.mark.parametrize("args,fault,caught_by", [
    (SELF, _altered_similarity, "sim_gap"),
    (SELF, _half_rows_left_out, "wrong_pairs"),
    (LINK, _altered_similarity, "sim_gap"),
    (LINK, _half_new_names_left_out, "wrong_pairs"),
    (LINK, _altered_nearest, "wrong_nearest"),
], ids=["self-altered-similarity", "self-half-rows", "link-altered-similarity",
        "link-half-new-names", "link-altered-answer"])
def test_planted_fault_is_not_correct(monkeypatch, args, fault, caught_by):
    seed = 3000000003
    sound = _sound(args, seed)
    assert sound["correct"] is True
    fault(monkeypatch)
    res = _sound(args, seed)
    assert res["correct"] is False
    c = res["checks"][caught_by]
    assert c["value"] > c["limit"]

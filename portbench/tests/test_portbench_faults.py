"""A run whose timed path is broken underneath reads ``correct`` false: the
rest of the run as the driver does it, on the CPU rehearsal, once for each
fault the cell can have. A sound rehearsal of the same seed reads true."""

import numpy as np
import pytest

SEED = 2**31 + 5


def _correct(out):
    return all(c.ok for c in out.checks)


def test_a_sound_train_rehearsal_is_correct(rehearse):
    assert _correct(rehearse("va-train", SEED, 0.5)[1])


def test_a_step_that_leaves_the_state_unchanged_is_caught(rehearse, monkeypatch):
    import vqwild_tpu_torch.train.step as step

    monkeypatch.setattr(step, "_optimizer_update", lambda state, grads, mesh=None: None)
    _, out = rehearse("va-train", SEED, 0.5)
    checks = {c.name: c for c in out.checks}
    assert not _correct(out) and checks["change_gap"].value == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_caught(rehearse):
    _, out = rehearse("va-train", SEED, 0.5, mode="fault:half_batch")
    assert not _correct(out)


@pytest.mark.parametrize("cell", ["va-serve-clip", "vasa-serve-moment"])
def test_a_sound_serve_rehearsal_is_correct(rehearse, cell):
    assert _correct(rehearse(cell, SEED, 1.0)[1])


@pytest.mark.parametrize("cell", ["va-serve-clip", "vasa-serve-moment"])
def test_an_answer_altered_where_it_is_produced_is_caught(rehearse, monkeypatch, cell):
    import vqwild_tpu_torch.serve.index as index

    real = index._masked_topk

    def altered(scorer, n, qfeats, k):  # the second row's answer where the first's should be
        s, i = real(scorer, n, qfeats, k)
        return s, np.roll(i, -1, axis=1)

    monkeypatch.setattr(index, "_masked_topk", altered)
    _, out = rehearse(cell, SEED, 1.0)
    assert not _correct(out)
    assert {c.name: c.ok for c in out.checks}["failed_requests"]

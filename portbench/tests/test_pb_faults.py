"""A run with its timed path broken underneath comes out not correct,
once for each fault the training cell can have (a step that returns its
state unchanged; half of the batch left out, the mean over the rest),
and a sound tiny run comes out correct. The runs skip the look for a
card and run on the CPU at tiny sizes, against the cell's own limits.
The cell runs on one card, so it has no exchange between cards to leave
out."""

import pytest

from portbench import run
from portbench.tests import tiny


def _train(**hooks):
    return run.run_cell("sc2-3b-train-4k", 2 ** 31 + 9, 1.0, False,
                        device="cpu", overrides=tiny.TRAIN, **hooks)


def test_train_sound_run_is_correct():
    assert _train()["correct"]


def test_train_state_left_unchanged_is_caught():
    from rlo_tpu_torch.models.transformer import loss_fn

    def unchanged(params, opt, tokens, cfg):
        return params, loss_fn(params, tokens, cfg).detach()

    res = _train(step_fn=unchanged)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_is_caught():
    from rlo_tpu_torch.models.transformer import train_step_optim

    def half(params, opt, tokens, cfg):
        return train_step_optim(params, opt, tokens[:tokens.shape[0] // 2],
                                cfg)

    assert not _train(step_fn=half)["correct"]


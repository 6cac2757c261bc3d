"""The check sees a broken timed path: a CPU rehearsal of each cell (its
own drivers, metric readers, reference and limits, on a small
configuration; the look for a card skipped) with a fault planted under
the timed path reads ``correct`` false, and without one true. The cells
run on one chip, so no exchange between chips can be left out."""

import pytest
import torch

from perfbench import run
from perfbench.tests.rehearsal import MIXES, config_path, with_serving

SERVE = [("opt6.7b.decode", "tiny-opt")]
EVAL = [("mistral7b.ppl", "tiny-mistral"), ("opt6.7b.ppl", "tiny-opt")]


def rehearse(cell, cfg, kind, hooks=None, seed=31):
    return run.run_cell(cell, seed, 1.5 if kind == "serve" else 0.5, False,
                        "cpu", man=with_serving(run.manifest()),
                        config_path=config_path(cfg),
                        mix_override=MIXES[kind], hooks=hooks, t0=0.0)


def state_unchanged(driver):
    """Each decode step works on a copy of the cache and hands back the
    cache it was given."""
    eng = driver.engine
    step = eng._step

    def frozen(ids, cache, positions, **kw):
        if ids.shape[1] != 1:
            return step(ids, cache, positions, **kw)
        logits, _ = step(ids, {k: v.clone() for k, v in cache.items()},
                         positions, **kw)
        return logits, cache

    eng._step = frozen


def token_altered(driver):
    eng = driver.engine
    sample = eng._sample

    def altered(logits, temps):
        return (sample(logits, temps) + 1) % logits.shape[-1]

    eng._sample = altered


def half_batch(driver):
    """Each decode step computes the first half of the slots and copies
    their logits over the rest."""
    eng = driver.engine
    dl = eng.decode_logits

    def half(tokens):
        lg = dl(tokens)
        n = lg.shape[0] // 2
        return torch.cat([lg[:n], lg[:n]])

    eng.decode_logits = half


@pytest.mark.parametrize("cell,cfg", SERVE)
@pytest.mark.parametrize("fault", [None, state_unchanged, token_altered,
                                   half_batch],
                         ids=["sound", "state_unchanged", "token_altered",
                              "half_batch"])
def test_serve_cell_sees_the_fault(cell, cfg, fault):
    res = rehearse(cell, cfg, "serve", fault)
    assert res["check"] and res["attempted"] > 0
    assert res["correct"] is (fault is None), res["check"]


def eval_half_batch(driver):
    """The loss is the mean over the first half of each batch."""
    ev = driver.evaluate

    def half(fwd, split, batch_size, device):
        return ev(fwd, split[:batch_size // 2], batch_size=batch_size // 2,
                  device=device)

    driver.evaluate = half


def eval_answer_altered(driver):
    """The forward's logits at one position are rotated by one token."""
    fwd = driver.fwd

    def altered(ids):
        lg = fwd(ids)
        lg[:, 7] = lg[:, 7].roll(1, -1)
        driver.argmax[-1] = lg.argmax(-1)
        return lg

    driver.fwd = altered


@pytest.mark.parametrize("cell,cfg", EVAL)
@pytest.mark.parametrize("fault", [None, eval_half_batch, eval_answer_altered],
                         ids=["sound", "half_batch", "answer_altered"])
def test_eval_cell_sees_the_fault(cell, cfg, fault):
    res = rehearse(cell, cfg, "eval", fault)
    assert res["check"] and res["attempted"] > 0
    assert res["correct"] is (fault is None), res["check"]

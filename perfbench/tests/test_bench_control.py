"""The control comes out not correct: the reference in the next precision
below the recipe (``compare.CONTROL``: every MXINT8 activation grid, K
and V at MXINT4) put in the program's place fails one of each cell's compared
numbers, where the program passes them all. On the card it was read at
each cell's own size (``python3 -m perfbench.control``); here at a size a
test run holds, whose embeddings are scaled so that its logits spread as
the full width's do."""

import pytest

from perfbench import run
from perfbench.tests.rehearsal import MIXES, config_path, with_serving

CELLS = [("opt6.7b.decode", "tiny-opt", "serve"),
         ("opt6.7b.ppl", "tiny-opt", "eval"),
         ("mistral7b.ppl", "tiny-mistral", "eval")]


@pytest.mark.parametrize("cell,cfg,kind", CELLS)
def test_control_fails_where_the_program_passes(cell, cfg, kind):
    res = run.run_cell(cell, 17, 2.0 if kind == "serve" else 0.5, False,
                       "cpu", man=with_serving(run.manifest()),
                       config_path=config_path(cfg),
                       mix_override=MIXES[kind], control=True, t0=0.0)
    assert res["correct"], res["check"]
    control_check, control_correct = res["_control"]
    assert not control_correct, (control_check, res["check"])
    assert any(c["value"] > c["limit"] for c in control_check.values())

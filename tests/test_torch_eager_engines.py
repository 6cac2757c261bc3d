"""The eager engine against the JAX package's, on the tiny Llama of
``test_torch_eager_serving.py``: the port's ``DecodeEngine`` (the default,
``scan_layers=False``) and the JAX one over a request mix with continuous
batching and EOS, crossing a flush of the staged cache; the port's eager
and stacked engines against each other, as the JAX package's
``tests/test_scan_decode.py`` holds its own; ``generate`` against JAX
``generate``. Greedy tokens equal.
"""

import numpy as np
import pytest

from lqer_tpu.serving import DecodeEngine as JDecodeEngine
from lqer_tpu.serving import Request as JRequest
from lqer_tpu.serving import generate as jgenerate
from lqer_tpu_torch.serving import DecodeEngine, Request, generate
from lqer_tpu_torch.serving import decode as tdecode
from lqer_tpu_torch.testing import one_torch_thread_fixture
from test_torch_eager_serving import llama_model

_one_torch_thread = one_torch_thread_fixture()


def _mix(cls, eos=None, new_tokens=(20, 12, 6, 8)):
    """Four requests over two slots (continuous batching), every prompt in
    the 32-token bucket; the second ends at ``eos`` if given. With the
    default ``new_tokens`` the first decodes past the staged cache's flush
    (residue 48 at position 48)."""
    rng = np.random.default_rng(5)
    reqs = [cls(prompt_ids=[int(t) for t in rng.integers(0, 128, n)],
                max_new_tokens=m) for n, m in zip((30, 20, 17, 25),
                                                  new_tokens)]
    reqs[1].eos_token_id = eos
    return reqs


def test_engine_matches_jax_engine(monkeypatch):
    """The port's eager engine with the backend on the staged cache against
    the JAX eager engine: four requests over two slots, the second ending
    at its EOS token, a flush on the way; then the port's stacked engine on
    the same mix."""
    model = llama_model()
    (jp, jq, jb), (tp, tq, tb) = model.side("backend", False)
    kw = dict(num_slots=2, max_len=128, cache_dtype="mxint8-staged",
              lm_head_width=8)
    first = _mix(Request)
    DecodeEngine(tp, model.tcfg, tq, pallas_backend=tb, device="cpu",
                 **kw).run(first)
    eos = first[1].output_ids[4]
    jreqs = _mix(JRequest, eos)
    JDecodeEngine(jp, model.jcfg, jq, pallas_backend=jb, **kw).run(jreqs)
    assert len(jreqs[1].output_ids) == first[1].output_ids.index(eos) + 1
    flushes = []
    real = tdecode.flush_stage_to_main
    monkeypatch.setattr(tdecode, "flush_stage_to_main",
                        lambda *a: flushes.append(1) or real(*a))
    outs = []
    for scan in (False, True):
        reqs = _mix(Request, eos)
        DecodeEngine(tp, model.tcfg, tq, pallas_backend=tb, scan_layers=scan,
                     device="cpu", **kw).run(reqs)
        assert all(r.done for r in reqs)
        outs.append([r.output_ids for r in reqs])
    assert outs[0] == [r.output_ids for r in jreqs]
    assert outs[1] == outs[0]
    assert len(flushes) == 2                      # once in each engine


@pytest.mark.parametrize("mode,cache_dtype,max_len", [
    ("emulated", "bfloat16", 64), ("emulated", "mxint8-staged", 256),
    ("fp", "float32", 128), ("backend", "mxint4", 256),
    ("backend", "bfloat16", 64)])
def test_eager_and_stacked_engines_agree(mode, cache_dtype, max_len):
    """The port's eager and stacked engines serve the same tokens, as the
    JAX package's ``tests/test_scan_decode.py`` holds for its own."""
    model = llama_model()
    _, (tp, tq, tb) = model.side(mode, cache_dtype.startswith("mxint4"))
    outs = []
    for scan in (False, True):
        reqs = _mix(Request, new_tokens=(8, 6, 4, 4))
        DecodeEngine(tp, model.tcfg, tq, pallas_backend=tb, num_slots=2,
                     max_len=max_len, cache_dtype=cache_dtype,
                     scan_layers=scan, device="cpu").run(reqs)
        outs.append([r.output_ids for r in reqs])
    assert outs[0] == outs[1]
    assert len(set(outs[0][0])) > 2          # not a collapsed stream


def test_generate_matches_jax_generate():
    model = llama_model()
    (jp, jq, _), (tp, tq, _) = model.side("emulated", False)
    prompt = [5, 77, 12, 9, 100, 3, 64]
    want = jgenerate(jp, model.jcfg, prompt, max_new_tokens=8,
                     layer_qcfgs=jq, max_len=64)
    got = generate(tp, model.tcfg, prompt, max_new_tokens=8, layer_qcfgs=tq,
                   max_len=64, device="cpu")
    assert got == want and len(got) == 8

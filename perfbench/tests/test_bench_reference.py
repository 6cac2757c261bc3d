"""The plain reference against the port at a small width on the CPU. The
test may import the port; the reference imports nothing of it."""

import pytest
import torch

from perfbench import spec, system, weights
from perfbench.reference import quant
from perfbench.reference.model import Reference
from perfbench.tests.rehearsal import config_path


@pytest.mark.parametrize("width", [4, 8])
def test_block_grid_is_the_ports_quantizer(width):
    from lqer_tpu_torch.ops.quantizers import block_fp_quantizer

    g = torch.Generator().manual_seed(width)
    x = torch.randn(6, 40, 48, generator=g) * torch.logspace(-9, 2, 48)
    x[0, 0, :16] = 0.0
    ours = quant.mx(x, width)
    port = block_fp_quantizer(x, width=width, exponent_width=8,
                              exponent_bias=None, block_size=[1, 16],
                              skip_first_dim=True)
    assert torch.equal(ours, port)
    w = torch.randn(64, 96, generator=g)
    port_w = block_fp_quantizer(w, width=width, exponent_width=8,
                                exponent_bias=None, block_size=[1, 16],
                                skip_first_dim=False)
    assert torch.equal(quant.mx_weight(w, width), port_w)


@pytest.mark.parametrize("width", [4, 8])
def test_cache_grid_is_the_ports_cache_codes(width):
    from lqer_tpu_torch.parallel import collectives as c

    g = torch.Generator().manual_seed(10 + width)
    x = torch.randn(3, 2, 7, 64, generator=g)
    enc, dec = ((c.mx4_encode, c.mx4_decode) if width == 4
                else (c.mx8_encode, c.mx8_decode))
    assert torch.equal(quant.cache_grid(x, width),
                       dec(*enc(x, 16, zero_fill=1.0), 16))


@pytest.mark.parametrize("name", ["tiny-mistral", "tiny-opt"])
def test_reference_forward_matches_the_ports(name):
    """The port's packed forward (kernel backend, the plain versions of the
    kernels on the CPU) against the reference over the same draws: the
    same first token nearly everywhere and logits within a few hundredths
    of their spread for OPT (the port rounds its stream to bf16; 0.032
    here), equal to rounding for Mistral's f32 stream (0 here)."""
    from lqer_tpu_torch import models

    s = spec.load_config(name, config_path(name))
    cfg, params, backend, qcfgs = system.build(s, 3, "cpu")
    ids = torch.randint(0, s.vocab, (2, 48), generator=torch.Generator()
                        .manual_seed(1))
    kw = {} if s.arch == "opt" else {"fused_attention": True}
    with torch.no_grad():
        port = models.get_arch_module(cfg).forward(
            params, ids, cfg, qcfgs, backend=backend, **kw).float()
    ref = Reference(s, 3, "cpu", kv_grid="matmul", head="dense")
    ref = torch.stack(ref.logits(list(ids), [list(range(48))] * 2))
    agree = (port.argmax(-1) == ref.argmax(-1)).float().mean()
    assert agree >= 0.95
    rms = (port - ref).square().mean().sqrt() / ref.std()
    assert rms < (0.05 if s.arch == "opt" else 1e-4)


def test_draws_are_the_seeds():
    s = spec.load_config("tiny-mistral", config_path("tiny-mistral"))
    a = weights.layer(s, 2 ** 31 + 9, 1, "cpu")
    b = weights.layer(s, 2 ** 31 + 9, 1, "cpu")
    c = weights.layer(s, 2 ** 31 + 10, 1, "cpu")
    w = "self_attn.q_proj"
    assert torch.equal(a[w]["weight"], b[w]["weight"])
    assert not torch.equal(a[w]["weight"], c[w]["weight"])
    assert torch.equal(a[w]["A"], a[w]["A"].bfloat16().float())

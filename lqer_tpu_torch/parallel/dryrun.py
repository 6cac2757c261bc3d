"""The multi-rank dry run (the port of ``__graft_entry__.py``'s
``dryrun_multichip``).

``dryrun_multichip(n_ranks, tp, device, backend)`` spawns ``n_ranks``
ranks in one process group (``launch.run_ranks``) and runs the JAX
package's sequence on its tiny W4A8 L²QER Llama (vocab 512, hidden 128, 2
layers, 8 heads over 4 kv heads, rank 8, weights fake-quantized at every
forward; on the card hidden 512, since its attention kernels take head
dims 64, 80, 96 and 128) on a (dp, tp) mesh:

1. one sharded train step (``step.make_train_step``), its loss finite;
2. the tensor-parallel forward with MXINT8 collectives
   (``tp_forward.make_tp_forward``), its logits finite;
3. the mesh engine (``DecodeEngine(mesh=...)``) on the ``mxint8-staged``
   cache, then on ``float32``, 2 new tokens a request.

Rank 0 prints one line as JAX's does; the call returns it. Run it as
``python -m lqer_tpu_torch.parallel.dryrun --ranks 8 --tp 4 --device cpu
--backend gloo``. Two ranks on one card need ``--backend gloo`` (NCCL
takes one rank per device).
"""

from __future__ import annotations

import argparse

import torch

SEQ = 32


def _q(width, block, skip):
    return {"name": "block_fp", "width": width, "exponent_width": 8,
            "exponent_bias": None, "block_size": block,
            "skip_first_dim": skip}


# W4A8 L²QER, the weights fake-quantized at every forward (is_ptq False)
Q_CONFIG = {
    "linear": {"name": "flexible_lqer", "is_ptq": False,
               "x_quantizer": _q(8, [1, 16], True),
               "w_quantizer": _q(4, [1, 16], False),
               "b_quantizer": _q(8, [1, 16], False)},
    "matmul": {"name": "flexible", "x_quantizer": _q(8, [1, 16], True),
               "w_quantizer": _q(8, [1, 16], True)},
}
MODEL = dict(vocab_size=512, layers=2, heads=8, kv_heads=4, inter=256,
             max_pos=128)   # LlamaConfig.tiny's arguments besides hidden


def tiny_llama_setup(rank: int = 8, seed: int = 0, hidden: int = 128):
    """(cfg, params, layer_qcfgs) of the dry run's model (``MODEL`` at
    ``hidden``, ``Q_CONFIG``): seeded weights (``torch.Generator``), zero A
    and small random B on every linear."""
    from .. import models

    cfg = models.LlamaConfig.tiny(hidden=hidden, **MODEL)
    gen = torch.Generator().manual_seed(seed)
    params = models.init_params(cfg, gen)
    qcfgs = models.quantize_model(cfg, Q_CONFIG, {"linear": {"rank": rank}})
    for i in range(cfg.num_hidden_layers):
        for prefix, _ in models.quantizable_module_prefixes(cfg, i):
            out_dim, in_dim = params[prefix + ".weight"].shape
            params[prefix + ".A"] = torch.zeros(in_dim, rank)
            params[prefix + ".B"] = torch.randn(rank, out_dim,
                                                generator=gen) * 0.01
    return cfg, params, qcfgs


def _rank_dryrun(tp: int, device: str) -> str:
    import torch.distributed as dist

    from ..serving import DecodeEngine, Request
    from .mesh import axis_size, make_mesh
    from .sharding import shard_params
    from .step import make_train_step
    from .tp_forward import make_tp_forward

    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device(device)
    mesh = make_mesh(tp=tp, device_type=device)
    dp = axis_size(mesh, "dp")
    cfg, params, qcfgs = tiny_llama_setup(
        hidden=512 if device == "cuda" else 128)
    params = {k: v.to(dev) for k, v in params.items()}
    local = shard_params(params, mesh)
    ids = torch.zeros((max(2, dp), SEQ), dtype=torch.int64, device=dev)
    _, loss = make_train_step(cfg, qcfgs, mesh, lr=1e-4)(local, ids)
    loss = float(loss)
    assert loss == loss, "loss is NaN"
    logits = make_tp_forward(cfg, qcfgs, mesh, quantized_collectives=True)(
        local, ids)
    assert bool(torch.isfinite(logits).all()), \
        "quantized-collectives TP forward produced non-finite logits"
    engine = DecodeEngine(params, cfg, qcfgs, num_slots=max(2, dp),
                          max_len=128, cache_dtype="mxint8-staged",
                          device=device, mesh=mesh)
    reqs = [Request(prompt_ids=[3, 17, 42], max_new_tokens=2),
            Request(prompt_ids=[9, 8, 7], max_new_tokens=2)]
    engine.run(reqs)
    assert all(r.done and len(r.output_ids) == 2 for r in reqs), reqs
    engine_fp = DecodeEngine(params, cfg, qcfgs, num_slots=max(2, dp),
                             max_len=64, cache_dtype="float32",
                             device=device, mesh=mesh)
    reqs_fp = [Request(prompt_ids=[3, 17, 42], max_new_tokens=2)]
    engine_fp.run(reqs_fp)
    assert all(r.done for r in reqs_fp)
    line = (f"dryrun_multichip({dist.get_world_size()}): mesh=(dp={dp}, "
            f"tp={tp}) loss={loss:.4f} quantized_collectives=ok "
            f"sharded_engine_mxint8staged_tokens="
            f"{[r.output_ids for r in reqs]} "
            f"fp_tokens={[r.output_ids for r in reqs_fp]}")
    if dist.get_rank() == 0:
        print(line, flush=True)
    return line


def dryrun_multichip(n_ranks: int, tp: int | None = None,
                     device: str = "cuda", backend: str | None = None,
                     timeout: float = 600.0) -> str:
    """Run the dry run on ``n_ranks`` spawned ranks (``tp`` defaults to
    ``min(4, n_ranks)``, as in JAX; ``backend`` to NCCL on the card,
    ``gloo`` on the CPU); returns rank 0's line. Every rank must print the
    same tokens."""
    from .launch import run_ranks
    from .mesh import DEFAULT_BACKENDS

    tp = tp or min(4, n_ranks)
    lines = run_ranks(_rank_dryrun, n_ranks,
                      backend=backend or DEFAULT_BACKENDS[device],
                      device=device, args=(tp, device), timeout=timeout)
    if len(set(lines)) != 1:
        raise AssertionError(f"ranks disagree: {lines}")
    return lines[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    a = ap.parse_args(argv)
    dryrun_multichip(a.ranks, a.tp, a.device, a.backend)


if __name__ == "__main__":
    main()

"""The port's sharding rules, shards and collectives
(``lqer_tpu_torch/parallel``) against the JAX package's, and the
multi-host bring-up.

- ``spec_for_param`` (and its clip to each param's rank) equal to JAX's
  ``PartitionSpec`` entries for every param name of tiny Llama, Mistral
  and OPT models, the low-rank factors included;
- ``shard_params``' local shards on each rank of a (dp 1, tp 4) mesh equal
  to JAX's shards of the same arrays on a tp 4 mesh, and ``param_specs``
  (from the config) equal to the specs the shards were cut by;
- ``quantized_all_gather`` and ``quantized_psum_scatter`` at tp 4 against
  JAX's under ``shard_map`` on the same inputs, along rows and along
  features: equal to the bit (the codec and the ring's f32 order are
  JAX's); the exact all-reduce and all-gather too;
- the wire of the quantized tensor-parallel forward carries int8 payloads
  in its ring (JAX's ``test_quantized_collectives_move_int8``), the exact
  one none, and the bytes a row-parallel reduction sends;
- ``initialize_multihost`` from the environment in one process, then
  ``tp_over_ici_mesh`` (JAX's ``tests/test_multihost.py``).

The port's side runs on ``gloo`` ranks spawned from the test
(``launch.run_ranks``, one thread each, every group with a timeout): one
spawn of 4 ranks runs every check; this module imports no JAX at its top,
so the ranks can import it.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lqer_tpu_torch import models as tmodels
from lqer_tpu_torch.parallel import sharding as tsharding
from lqer_tpu_torch.parallel.launch import run_ranks
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

REPO = Path(__file__).resolve().parents[1]
TP = 4
TINY = {
    "llama": ("llama", dict(vocab_size=64, hidden=64, layers=2, heads=4,
                            kv_heads=2, inter=128)),
    "mistral": ("llama", dict(vocab_size=64, hidden=64, layers=1, heads=4,
                              kv_heads=1, inter=96, sliding_window=8,
                              arch="mistral")),
    "opt": ("opt", dict(vocab_size=62, hidden=64, layers=2, heads=4,
                        ffn=128)),
    "opt350m": ("opt", dict(vocab_size=64, hidden=64, layers=1, heads=4,
                            ffn=128, word_embed_proj_dim=32,
                            do_layer_norm_before=False)),
}


def _port_cfg(name):
    arch, kw = TINY[name]
    if arch == "llama":
        return tmodels.LlamaConfig.tiny(**kw)
    return tmodels.OPTConfig.tiny(**{k: v for k, v in kw.items()
                                     if k not in ("word_embed_proj_dim",
                                                  "do_layer_norm_before")},
                                  **{k: kw[k] for k in
                                     ("word_embed_proj_dim",
                                      "do_layer_norm_before") if k in kw})


def _numpy_params(name, seed=0):
    """A tiny model's params (the port's seeded init) with A/B factors on
    every quantized linear, as numpy."""
    cfg = _port_cfg(name)
    gen = torch.Generator().manual_seed(seed)
    params = tmodels.init_params(cfg, gen)
    for i in range(cfg.num_hidden_layers):
        for prefix, _ in tmodels.quantizable_module_prefixes(cfg, i):
            out_dim, in_dim = params[prefix + ".weight"].shape
            params[prefix + ".A"] = torch.randn(in_dim, 8, generator=gen)
            params[prefix + ".B"] = torch.randn(8, out_dim, generator=gen)
    return {k: v.numpy() for k, v in params.items()}


def _inputs():
    rng = np.random.default_rng(3)
    return {"rows": rng.standard_normal((16, 64)).astype(np.float32),
            "cols": rng.standard_normal((8, 128)).astype(np.float32),
            "partials": rng.standard_normal((TP, 32, 64)).astype(np.float32),
            "partials_f": rng.standard_normal((TP, 8, 128)).astype(
                np.float32)}


def _rank_checks(inputs):
    """Every check's port side on one rank of a tp 4 mesh."""
    import torch.distributed as dist

    from lqer_tpu_torch.parallel import collectives as C
    from lqer_tpu_torch.parallel.mesh import make_mesh
    from lqer_tpu_torch.parallel.sharding import param_specs, shard_params
    from lqer_tpu_torch.parallel.tp_forward import make_tp_forward

    mesh = make_mesh(tp=TP, device_type="cpu")
    g = mesh.get_group("tp")
    r = dist.get_rank(g)
    out = {"rank": r}
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out["all_gather_rows"] = C.quantized_all_gather(
        t["rows"].chunk(TP)[r], g).numpy()
    out["all_gather_cols"] = C.quantized_all_gather(
        t["cols"].chunk(TP, dim=1)[r], g, gather_axis=1).numpy()
    out["psum_scatter_rows"] = C.quantized_psum_scatter(
        t["partials"][r], g).numpy()
    out["psum_scatter_cols"] = C.quantized_psum_scatter(
        t["partials_f"][r], g, scatter_axis=1).numpy()
    out["all_reduce"] = C.all_reduce(t["partials"][r], g).numpy()
    out["all_gather"] = C.all_gather(t["rows"].chunk(TP)[r], g).numpy()
    out["shards"], out["specs"] = {}, {}
    for name in TINY:
        local = shard_params({k: torch.from_numpy(v) for k, v in
                              _numpy_params(name).items()}, mesh)
        out["shards"][name] = {k: v.numpy() for k, v in local.items()}
        out["specs"][name] = param_specs(_port_cfg(name), local, TP)
    # what crosses the ring of the quantized tensor-parallel forward
    from lqer_tpu_torch.serving.random_model import q_config_for

    cfg = tmodels.LlamaConfig.tiny(vocab_size=64, hidden=64, layers=1,
                                   heads=4, kv_heads=4, inter=128)
    params = tmodels.init_params(cfg, torch.Generator().manual_seed(2))
    qcfgs = tmodels.quantize_model(cfg, q_config_for(cfg), None)
    local = shard_params(tmodels.prepare_ptq(params, cfg, qcfgs), mesh)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    real = C._ring_shift
    for quantized in (True, False):
        sent = []

        def spy(tensors, group):
            sent.append([str(x.dtype) for x in tensors])
            return real(tensors, group)

        C._ring_shift = spy
        try:
            make_tp_forward(cfg, qcfgs, mesh,
                            quantized_collectives=quantized)(local, ids)
        finally:
            C._ring_shift = real
        out[f"ring_dtypes_{quantized}"] = sent
    # the bytes one row-parallel reduction sends, quantized and exact
    from lqer_tpu_torch.parallel.tp_forward import reduce_row_parallel

    y = torch.from_numpy(inputs["partials_f"][r])[None]
    for quantized in (True, False):
        C.reset_wire_counts()
        reduce_row_parallel(y, g, quantized)
        out[f"reduce_bytes_{quantized}"] = C.wire_counts()["sent_bytes"]
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_rank_checks, TP, backend="gloo", device="cpu",
                     args=(_inputs(),), timeout=300)


@pytest.fixture(scope="module")
def jax_tp_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:TP]), axis_names=("tp",))


def _jax_names(name):
    """Every param name of the JAX package's init of the same model, with
    A/B on its quantized linears."""
    import jax

    from lqer_tpu import models as jmodels
    from lqer_tpu.models import LlamaConfig, OPTConfig

    arch, kw = TINY[name]
    cls = LlamaConfig if arch == "llama" else OPTConfig
    if arch == "llama":
        jcfg = cls.tiny(**kw)
    else:
        base = {k: v for k, v in kw.items()
                if k not in ("word_embed_proj_dim", "do_layer_norm_before")}
        jcfg = cls(vocab_size=base["vocab_size"], hidden_size=base["hidden"],
                   ffn_dim=base["ffn"], num_hidden_layers=base["layers"],
                   num_attention_heads=base["heads"],
                   max_position_embeddings=128,
                   **{k: kw[k] for k in ("word_embed_proj_dim",
                                         "do_layer_norm_before") if k in kw})
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    names = set(params)
    for i in range(jcfg.num_hidden_layers):
        for prefix, _ in jmodels.quantizable_module_prefixes(jcfg, i):
            names |= {prefix + ".A", prefix + ".B"}
    return names, {k: np.ndim(v) for k, v in params.items()}


@pytest.mark.parametrize("name", sorted(TINY))
def test_spec_for_param_equals_jax(name):
    from lqer_tpu.parallel.sharding import _clip_spec, spec_for_param

    names, ndims = _jax_names(name)
    assert names == set(_numpy_params(name))
    for n in sorted(names):
        assert tsharding.spec_for_param(n) == tuple(spec_for_param(n)), n
        nd = ndims.get(n, 2)
        assert tsharding._clip_spec(tsharding.spec_for_param(n), nd) == \
            tuple(_clip_spec(spec_for_param(n), nd)), n


def test_sharding_for_param_placements():
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:   # placements need no process group
        pass

    assert tsharding.sharding_for_param(
        _Mesh(), "model.layers.0.self_attn.q_proj.weight", 2) == \
        (Replicate(), Shard(0))
    assert tsharding.sharding_for_param(
        _Mesh(), "model.layers.0.mlp.down_proj.weight", 2) == \
        (Replicate(), Shard(1))
    assert tsharding.sharding_for_param(
        _Mesh(), "model.layers.0.mlp.up_proj.A", 2) == \
        (Replicate(), Replicate())
    assert tsharding.sharding_for_param(_Mesh(), "model.norm.weight", 1) == \
        (Replicate(), Replicate())


@pytest.mark.parametrize("name", sorted(TINY))
def test_shard_params_equals_jax_shards(name, ranks, jax_tp_mesh):
    """Each rank's local shard is the JAX array's shard on the device at the
    same tp coordinate; ``param_specs`` from the config names the same
    split."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    params = _numpy_params(name)
    for n, full in params.items():
        spec = tsharding.fixed_spec(n, full.shape, TP)
        arr = jax.device_put(full, NamedSharding(jax_tp_mesh, P(*spec)))
        by_device = {s.device: np.asarray(s.data)
                     for s in arr.addressable_shards}
        for res in ranks:
            want = by_device[jax_tp_mesh.devices[res["rank"]]]
            np.testing.assert_array_equal(res["shards"][name][n], want,
                                          err_msg=n)
            assert res["specs"][name][n] == spec, n


def _jax_collective(fn, x, in_spec, out_spec, mesh):
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    return np.asarray(jax.jit(shard_map(
        fn, mesh=mesh, in_specs=P(*in_spec), out_specs=P(*out_spec),
        check_vma=False))(jax.numpy.asarray(x)))


@pytest.mark.parametrize("case", ["all_gather_rows", "all_gather_cols",
                                  "psum_scatter_rows", "psum_scatter_cols"])
def test_quantized_collectives_equal_jax(case, ranks, jax_tp_mesh):
    from lqer_tpu.parallel import collectives as jc

    x = _inputs()
    if case == "all_gather_rows":
        want = _jax_collective(lambda v: jc.quantized_all_gather(v, "tp"),
                               x["rows"], ("tp", None), (None, None),
                               jax_tp_mesh)
        got = [r[case] for r in ranks]
    elif case == "all_gather_cols":
        want = _jax_collective(
            lambda v: jc.quantized_all_gather(v, "tp", gather_axis=1),
            x["cols"], (None, "tp"), (None, None), jax_tp_mesh)
        got = [r[case] for r in ranks]
    elif case == "psum_scatter_rows":
        want = _jax_collective(
            lambda v: jc.quantized_psum_scatter(v[0], "tp"),
            x["partials"], ("tp", None, None), ("tp", None), jax_tp_mesh)
        got = [np.concatenate([r[case] for r in ranks])]
    else:
        want = _jax_collective(
            lambda v: jc.quantized_psum_scatter(v[0], "tp", scatter_axis=1),
            x["partials_f"], ("tp", None, None), (None, "tp"), jax_tp_mesh)
        got = [np.concatenate([r[case] for r in ranks], axis=1)]
    for g in got:
        np.testing.assert_array_equal(g, want)
    if case.startswith("psum"):   # close to the exact reduce-scatter
        exact = x["partials" if case.endswith("rows") else "partials_f"].sum(0)
        assert np.abs(got[0] - exact).max() / np.abs(exact).max() < 0.05


def test_exact_collectives(ranks):
    x = _inputs()
    for r in ranks:
        np.testing.assert_allclose(r["all_reduce"], x["partials"].sum(0),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r["all_reduce"], ranks[0]["all_reduce"])
        np.testing.assert_array_equal(r["all_gather"], x["rows"])


def test_quantized_collectives_move_int8(ranks):
    """The quantized forward's ring moves int8 codes and exponents only;
    the exact forward has no ring. One row-parallel reduction of (8, 128)
    f32 partials sends codes and exponents, 1 + 1/16 bytes a value, about
    0.27x of the exact all-reduce's f32."""
    for r in ranks:
        sent = r["ring_dtypes_True"]
        assert sent and all(d == ["torch.int8", "torch.int8"] for d in sent)
        assert r["ring_dtypes_False"] == []
        n_values = 8 * 128
        assert r["reduce_bytes_False"] == 2 * (TP - 1) * n_values * 4 // TP
        assert r["reduce_bytes_True"] == 2 * (TP - 1) * (
            n_values + n_values // 16) // TP
        ratio = r["reduce_bytes_True"] / r["reduce_bytes_False"]
        assert 0.26 < ratio < 0.27


_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
import torch
from lqer_tpu_torch.parallel.collectives import all_reduce
from lqer_tpu_torch.parallel.mesh import initialize_multihost, tp_over_ici_mesh
from lqer_tpu_torch.parallel.sharding import shard_params
import torch.distributed as dist

initialize_multihost(backend="gloo", device_type="cpu")
assert dist.get_world_size() == 1 and dist.get_rank() == 0
mesh = tp_over_ici_mesh(device_type="cpu")
assert mesh.mesh_dim_names == ("dp", "tp")
x = shard_params({{"model.embed_tokens.weight": torch.arange(8.0 * 8).reshape(8, 8)}},
                 mesh)["model.embed_tokens.weight"]
total = all_reduce(x.sum(), mesh.get_group("tp"))
print("MULTIHOST_OK", tuple(mesh.shape), float(total))
dist.destroy_process_group()
"""


def test_single_process_distributed_bringup():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               RANK="0", WORLD_SIZE="1", LOCAL_WORLD_SIZE="1")
    out = subprocess.run([sys.executable, "-c",
                          _SCRIPT.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=240, env=env)
    assert "MULTIHOST_OK (1, 1) 2016.0" in out.stdout, (out.stdout,
                                                       out.stderr)

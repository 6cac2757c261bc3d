"""Tensor and data parallelism over ``torch.distributed`` (port of
``lqer_tpu/parallel``): the (dp, tp) mesh, the sharding rules, the
collectives (MXINT codec, exact and quantized collectives), the
tensor-parallel forward, the sharded forward and train step, the rank
launcher and the multi-rank dry run. ``make_tp_forward`` is imported on
first use (the quantizers import this package's codec)."""

from .mesh import make_mesh, mesh_shape_for
from .sharding import param_sharding_rules, shard_params, sharding_for_param


def __getattr__(name):
    if name == "make_tp_forward":
        from .tp_forward import make_tp_forward

        return make_tp_forward
    raise AttributeError(name)


__all__ = ["make_mesh", "make_tp_forward", "mesh_shape_for",
           "param_sharding_rules", "sharding_for_param", "shard_params"]

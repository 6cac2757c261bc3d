"""``jnp.exp2`` built from bits in modules of the JAX package while a block
runs (:func:`exact_exp2`).

The JAX package's block_fp quantizers (``lqer_tpu/ops/quantizers.py``), its
MXINT storage codec (``lqer_tpu/ops/storage.py``) and its quantized
collectives (``lqer_tpu/parallel/collectives.py``) scale by ``jnp.exp2`` of
whole numbers, whose powers of two XLA:CPU's exp2 misses by up to 34 ulps
below -12 (ROADMAP §3). The port builds each power from its bits. The
package's files stay as they are; this module imports no JAX at its top.
"""

import contextlib
import importlib


@contextlib.contextmanager
def exact_exp2(*module_names: str):
    """Within the block, each named module's ``jnp.exp2`` is exact for whole
    numbers. Enter it before the process traces a jitted function of those
    modules (``make_quantizer`` keeps its jitted callables)."""
    import jax
    import jax.numpy as jnp

    modules = [importlib.import_module(n) for n in module_names]

    def exp2(x):
        k = jnp.asarray(x).astype(jnp.int32)
        bits = jax.lax.bitcast_convert_type
        normal = bits(jnp.clip(k + 127, 1, 255) << 23, jnp.float32)
        sub = bits(jnp.left_shift(jnp.int32(1), jnp.clip(k + 149, 0, 22)),
                   jnp.float32)
        return jnp.where(k >= -126, normal, sub)

    class _Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

    patched = _Jnp()
    patched.exp2 = exp2
    for m in modules:
        m.jnp = patched
    try:
        yield
    finally:
        for m in modules:
            m.jnp = jnp

"""Row 12, the row write of every layer in one launch
(``write_kv_rows_all_layers``): the port's plain version against the JAX
package's ``write_kv_rows_all_layers`` (Pallas in interpret mode),
bit-exact, for the MXINT8 and MXINT4 code and exponent columns (token axis
on dim 4) and the bf16 K/V rows of the fp cache (token axis on dim 3, f32
rows rounded to nearest even); and equal to the single-layer row write
(row 11) applied layer by layer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqer_tpu.ops.pallas.cache_write import (
    write_kv_rows_all_layers as jax_all_layers,
)
from lqer_tpu_torch.ops.kernels import cache_write as tcw
from lqer_tpu_torch.testing import one_torch_thread_fixture

_one_torch_thread = one_torch_thread_fixture()

NL, B, KVH, D, L = 3, 4, 2, 64, 256
POS = np.array([0, 127, 128, 255], np.int32)


def _case(kind, seed):
    """Cache arrays and each layer's new rows (numpy) of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "bf16 rows":
        arrays = [rng.standard_normal((NL, B, KVH, L, D)).astype(np.float32)
                  for _ in range(2)]
        arrays = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
        rows = [rng.standard_normal((NL, B, KVH, 1, D)).astype(np.float32)
                for _ in range(2)]
        return arrays, rows
    code_rows = D if kind == "mxint8 columns" else D // 2
    shapes = [code_rows, D // 16] * 2
    arrays = [torch.from_numpy(rng.integers(-128, 128, (NL, B, KVH, r, L))
                               .astype(np.int8)) for r in shapes]
    rows = [rng.integers(-128, 128, (NL, B, KVH, r, 1)).astype(np.int8)
            for r in shapes]
    return arrays, rows


def _jax(a: torch.Tensor):
    if a.dtype == torch.bfloat16:
        return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(a.numpy())


@pytest.mark.parametrize("kind", ["mxint8 columns", "mxint4 columns",
                                  "bf16 rows"])
def test_plain_matches_jax(kind):
    arrays, rows = _case(kind, seed=len(kind))
    want = jax_all_layers(tuple(_jax(a) for a in arrays),
                          tuple(jnp.asarray(r) for r in rows),
                          jnp.asarray(POS), interpret=True)
    ours = [a.clone() for a in arrays]
    tcw.write_kv_rows_all_layers(tuple(ours),
                                 tuple(torch.from_numpy(r) for r in rows),
                                 torch.from_numpy(POS))
    for mine, theirs in zip(ours, want):
        got = mine.float().numpy() if mine.dtype == torch.bfloat16 \
            else mine.numpy()
        np.testing.assert_array_equal(got, np.asarray(theirs).astype(
            got.dtype))
    # layer by layer through the single-layer row write
    per_layer = [a.clone() for a in arrays]
    for li in range(NL):
        tcw.write_kv_rows_stacked(
            tuple(per_layer), tuple(torch.from_numpy(r[li]) for r in rows),
            li, torch.from_numpy(POS))
    assert all(torch.equal(a, b) for a, b in zip(ours, per_layer))
    assert tcw.write_kv_rows_all_layers.launches == 0   # CPU: plain version


def test_rows_need_a_layer_axis():
    arrays, rows = _case("mxint8 columns", seed=1)
    with pytest.raises(ValueError, match="leading axis"):
        tcw.write_kv_rows_all_layers(
            tuple(arrays), tuple(torch.from_numpy(r[0]) for r in rows),
            torch.from_numpy(POS))

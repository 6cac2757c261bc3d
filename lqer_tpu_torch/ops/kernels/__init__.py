"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. A wrapper launches its CUDA kernel for CUDA tensors and counts the
launch in its ``launches`` attribute; for CPU tensors it runs the plain
version and counts nothing. The staged decode wrappers (rows 7 and 9) also
count their launches at code width 4 in ``launches_width4``."""

from __future__ import annotations

from .attention import quantized_attention
from .cache_write import (
    flush_stage_to_main,
    write_kv_rows_all_layers,
    write_kv_rows_stacked,
    write_kv_tokens_fused,
)
from .decode_attention import decode_attention_quantized_staged
from .fp_decode import decode_attention_fp
from .quantized_decode import (
    decode_attention_quantized,
    decode_attention_quantized_write,
)
from .dequant_gemm import qlinear_w4_fused, unpack_packed_to_bf16
from .mlp_fused import mlp_w4_fused, mlp_w4_fused_relu
from .streaming_decode import (
    decode_attention_quantized_streaming,
    decode_attention_quantized_streaming_staged,
)

# name -> (wrapper, CUDA source, TPU kernel it replaces)
KERNELS = {
    "dequant_gemm": (qlinear_w4_fused, "lqer_tpu_torch/csrc/dequant_gemm.cu",
                     "lqer_tpu/ops/pallas/dequant_gemm.py:117"),
    "attention": (quantized_attention, "lqer_tpu_torch/csrc/attention.cu",
                  "lqer_tpu/ops/pallas/attention.py:58"),
    "decode_attention": (decode_attention_quantized_staged,
                         "lqer_tpu_torch/csrc/decode_attention.cu",
                         "lqer_tpu/ops/pallas/decode_attention.py:575"),
    "cache_write": (flush_stage_to_main, "lqer_tpu_torch/csrc/cache_write.cu",
                    "lqer_tpu/ops/pallas/cache_write.py:333"),
    "unpack": (unpack_packed_to_bf16, "lqer_tpu_torch/csrc/unpack.cu",
               "lqer_tpu/ops/pallas/dequant_gemm.py:401"),
    "mlp_fused": (mlp_w4_fused, "lqer_tpu_torch/csrc/mlp_fused.cu",
                  "lqer_tpu/ops/pallas/mlp_fused.py:63"),
    # the same TPU kernel's un-gated variant with biases (gated=False,
    # has_bias=True: OPT's fc1 and fc2), counted apart
    "mlp_fused_relu": (mlp_w4_fused_relu, "lqer_tpu_torch/csrc/mlp_fused.cu",
                       "lqer_tpu/ops/pallas/mlp_fused.py:63"),
    "decode_attention_fp": (decode_attention_fp,
                            "lqer_tpu_torch/csrc/decode_attention_fp.cu",
                            "lqer_tpu/ops/pallas/decode_attention.py:67"),
    "decode_attention_quantized": (
        decode_attention_quantized,
        "lqer_tpu_torch/csrc/decode_attention_quantized.cu",
        "lqer_tpu/ops/pallas/decode_attention.py:290"),
    "decode_attention_write": (
        decode_attention_quantized_write,
        "lqer_tpu_torch/csrc/decode_attention_quantized.cu",
        "lqer_tpu/ops/pallas/decode_attention.py:1504"),
    "row_write": (write_kv_rows_stacked, "lqer_tpu_torch/csrc/cache_write.cu",
                  "lqer_tpu/ops/pallas/cache_write.py:48"),
    "decode_attention_streaming": (
        decode_attention_quantized_streaming,
        "lqer_tpu_torch/csrc/decode_attention_streaming.cu",
        "lqer_tpu/ops/pallas/decode_attention.py:819"),
    "decode_attention_streaming_staged": (
        decode_attention_quantized_streaming_staged,
        "lqer_tpu_torch/csrc/decode_attention.cu",
        "lqer_tpu/ops/pallas/decode_attention.py:1145"),
    "encode_write_tokens": (write_kv_tokens_fused,
                            "lqer_tpu_torch/csrc/cache_write.cu",
                            "lqer_tpu/ops/pallas/cache_write.py:248"),
    "row_write_all": (write_kv_rows_all_layers,
                      "lqer_tpu_torch/csrc/cache_write.cu",
                      "lqer_tpu/ops/pallas/cache_write.py:211"),
}


def reset_launch_counts() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
        if hasattr(wrapper, "launches_width4"):
            wrapper.launches_width4 = 0


def launch_counts() -> dict[str, int]:
    """Each entry's launches, and ``"{name}.width4"`` for the entries that
    count their code-width-4 launches apart."""
    counts = {}
    for name, (w, _, _) in KERNELS.items():
        counts[name] = w.launches
        if hasattr(w, "launches_width4"):
            counts[f"{name}.width4"] = w.launches_width4
    return counts

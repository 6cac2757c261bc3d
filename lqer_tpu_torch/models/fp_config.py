"""Pre-resolved full-precision (passthrough) layer configs (port of
``lqer_tpu/models/fp_config.py``): the default when no q_config is given,
so one forward serves both the FP baseline and the quantized model."""

from ..ops.qlinear import QLinearConfig, resolve_qmatmul
from .common import AttnQConfig

_FP = QLinearConfig()

FP_LAYER_OPT = {
    "attn": AttnQConfig(
        q_proj=_FP, k_proj=_FP, v_proj=_FP, o_proj=_FP,
        qk_matmul=resolve_qmatmul(None), pv_matmul=resolve_qmatmul(None),
    ),
    "fc1": _FP,
    "fc2": _FP,
}

FP_LAYER_LLAMA = {
    "attn": AttnQConfig(
        q_proj=_FP, k_proj=_FP, v_proj=_FP, o_proj=_FP,
        qk_matmul=resolve_qmatmul(None), pv_matmul=resolve_qmatmul(None),
    ),
    "gate_proj": _FP,
    "up_proj": _FP,
    "down_proj": _FP,
}

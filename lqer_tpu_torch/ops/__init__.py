from .quantizers import (
    block_fp_quantizer,
    get_quantizer,
    integer_quantizer,
    make_quantizer,
    minifloat_denorm_quantizer,
    minifloat_ieee_quantizer,
    passthrough_quantizer,
)
from .qlinear import QLinearConfig, qlinear, qmatmul, resolve_qmatmul

__all__ = [
    "block_fp_quantizer", "get_quantizer", "integer_quantizer",
    "make_quantizer", "minifloat_denorm_quantizer", "minifloat_ieee_quantizer",
    "passthrough_quantizer", "QLinearConfig", "qlinear", "qmatmul",
    "resolve_qmatmul",
]

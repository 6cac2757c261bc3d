from .decode import make_cache, model_step
from .engine import DecodeEngine, Request, generate
from .kv_cache import decode_mask, init_kv_cache, prefill_mask, update_layer_cache

__all__ = [
    "model_step",
    "make_cache",
    "DecodeEngine",
    "Request",
    "generate",
    "init_kv_cache",
    "update_layer_cache",
    "decode_mask",
    "prefill_mask",
]

from .engine import DecodeEngine, Request

__all__ = ["DecodeEngine", "Request"]

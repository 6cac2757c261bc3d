from .config import convert_str_na_to_none, load_config
from .logging import get_logger, root_logger

__all__ = ["convert_str_na_to_none", "get_logger", "load_config",
           "root_logger"]

from .config import (
    convert_none_to_str_na,
    convert_str_na_to_none,
    find_all_matched_patterns,
    find_matched_pattern,
    flatten_dict,
    get_dict_value,
    load_config,
    override_args,
    save_config,
    set_dict_value,
)
from .logging import get_logger, root_logger, set_logging_verbosity

__all__ = ["convert_none_to_str_na", "convert_str_na_to_none",
           "find_all_matched_patterns", "find_matched_pattern",
           "flatten_dict", "get_dict_value", "get_logger", "load_config",
           "override_args", "root_logger", "save_config", "set_dict_value",
           "set_logging_verbosity"]

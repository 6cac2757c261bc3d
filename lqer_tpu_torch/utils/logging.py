"""The package's logger (port of ``lqer_tpu/utils/logging.py``): one
``lqer_tpu_torch`` root at INFO with a plain stream handler (colorlog when
installed), a child per component, and :func:`set_logging_verbosity`."""

from __future__ import annotations

import logging

_FMT = "%(asctime)s %(levelname)-8s %(name)s: %(message)s"


def _make_root_logger() -> logging.Logger:
    logger = logging.getLogger("lqer_tpu_torch")
    if logger.handlers:
        return logger
    handler = logging.StreamHandler()
    try:
        import colorlog

        handler.setFormatter(colorlog.ColoredFormatter("%(log_color)s" + _FMT))
    except ImportError:
        handler.setFormatter(logging.Formatter(_FMT))
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    return logger


root_logger = _make_root_logger()


def get_logger(name: str) -> logging.Logger:
    return root_logger.getChild(name)


def set_logging_verbosity(level: str = "info") -> None:
    levels = {"debug": logging.DEBUG, "info": logging.INFO,
              "warning": logging.WARNING, "error": logging.ERROR,
              "critical": logging.CRITICAL}
    root_logger.setLevel(levels[level.lower()])

"""Leveled logging (clog analogue, QNNPACK src/qnnpack/log.h:9-29).

The level comes from the QNNPACK_TPU_TORCH_LOG_LEVEL environment variable
or `set_log_level`."""

from __future__ import annotations

import logging
import os

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "error": logging.ERROR,
           "fatal": logging.CRITICAL, "none": logging.CRITICAL + 10}

logger = logging.getLogger("qnnpack_tpu_torch")

if not logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(
        logging.Formatter("%(asctime)s [%(name)s %(levelname)s] %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(_LEVELS.get(
        os.environ.get("QNNPACK_TPU_TORCH_LOG_LEVEL", "warning").lower(),
        logging.WARNING))


def set_log_level(level: str):
    logger.setLevel(_LEVELS[level.lower()])


log_debug = logger.debug
log_info = logger.info
log_warning = logger.warning
log_error = logger.error

"""Leveled logging (clog analogue, QNNPACK src/qnnpack/log.h:9-29).

The level comes from the QNNPACK_TPU_TORCH_LOG_LEVEL environment variable."""

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

log_error = logger.error

"""Support utilities: logging, timing, profiling, checkpointing."""

from .checkpoint import load_params, save_params  # noqa: F401
from .logging import (  # noqa: F401
    log_debug, log_error, log_info, log_warning, logger, set_log_level,
)
from .profiling import OpCost, graph_cost, total_cost, trace  # noqa: F401

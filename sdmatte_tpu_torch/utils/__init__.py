from .env import env_flag  # noqa: F401
from .observability import (  # noqa: F401
    METRICS, Metrics, get_logger, timed, trace,
)

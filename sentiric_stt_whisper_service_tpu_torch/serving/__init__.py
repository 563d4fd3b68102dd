from .metrics import AppMetrics  # noqa: F401
from .suts_logging import setup_logging  # noqa: F401

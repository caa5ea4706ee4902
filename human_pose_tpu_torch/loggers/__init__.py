from .loggers import BaseLogger, FileTrackerLogger, Loggers, MlflowFileLogger, Status, TerminalLogger
from .monitoring import GpuInfoMonitor, SystemMetricsMonitor, collect_sample
from .pylogger import (
    add_file_handler,
    capture_warnings,
    get_pylogger,
    log,
    log_breaking_point,
    logged_tqdm,
    set_device_tag,
)

__all__ = [
    "log",
    "get_pylogger",
    "add_file_handler",
    "capture_warnings",
    "set_device_tag",
    "logged_tqdm",
    "log_breaking_point",
    "Loggers",
    "BaseLogger",
    "TerminalLogger",
    "FileTrackerLogger",
    "MlflowFileLogger",
    "Status",
    "SystemMetricsMonitor",
    "GpuInfoMonitor",
    "collect_sample",
]

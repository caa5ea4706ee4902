"""Colored console logger + per-device file logger (port of
human_pose_tpu/loggers/pylogger.py).

Counterpart of reference src/logger/pylogger.py: every record carries a
device/rank tag; a file handler can be attached per run directory; warnings are
routed through the logger.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

from ..utils.utils import is_main_process

_COLORS = {
    logging.DEBUG: "\x1b[38;5;245m",
    logging.INFO: "\x1b[38;5;39m",
    logging.WARNING: "\x1b[38;5;214m",
    logging.ERROR: "\x1b[38;5;196m",
    logging.CRITICAL: "\x1b[31;1m",
}
_RESET = "\x1b[0m"


class _DeviceFormatter(logging.Formatter):
    def __init__(self, device: str = "cuda:0", colored: bool = True):
        super().__init__()
        self.device = device
        self.colored = colored

    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "") if self.colored else ""
        reset = _RESET if self.colored else ""
        base = (
            f"{self.formatTime(record, '%Y-%m-%d %H:%M:%S')} "
            f"[{self.device}] {record.levelname:<8} {record.getMessage()}"
        )
        return f"{color}{base}{reset}"


def get_pylogger(name: str = "human_pose_tpu_torch", device: str = "cuda:0") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(_DeviceFormatter(device))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def set_device_tag(logger: logging.Logger, device: str) -> None:
    for h in logger.handlers:
        if isinstance(h.formatter, _DeviceFormatter):
            h.formatter.device = device


def add_file_handler(logger: logging.Logger, filepath: str | Path, device: str = "cuda:0") -> logging.Handler:
    Path(filepath).parent.mkdir(parents=True, exist_ok=True)
    fh = logging.FileHandler(filepath)
    fh.setFormatter(_DeviceFormatter(device, colored=False))
    logger.addHandler(fh)
    return fh


def capture_warnings(logger_name: str = "human_pose_tpu_torch") -> None:
    logging.captureWarnings(True)
    warn_logger = logging.getLogger("py.warnings")
    for h in logging.getLogger(logger_name).handlers:
        warn_logger.addHandler(h)


log = get_pylogger()


class logged_tqdm:
    """tqdm wrapper that mirrors the progress line into the file logger by
    rewriting on a fixed cadence (reference pylogger.py:141-164)."""

    def __init__(self, iterable, logger: logging.Logger | None = None,
                 every_n: int = 50, **tqdm_kwargs):
        from tqdm.auto import tqdm

        self.pbar = tqdm(iterable, **tqdm_kwargs)
        self.logger = logger or log
        self.every_n = every_n

    def __iter__(self):
        for i, item in enumerate(self.pbar):
            if i % self.every_n == 0:
                self.logger.info(str(self.pbar))
            yield item

    def set_postfix(self, *a, **kw):
        self.pbar.set_postfix(*a, **kw)


def log_breaking_point(msg: str, logger: logging.Logger | None = None,
                       n_top: int = 1, n_bottom: int = 1, num_chars: int = 70) -> None:
    """Rank-gated banner separating training phases
    (reference pylogger.py:167-184)."""
    if not is_main_process():
        return
    lg = logger or log
    for _ in range(n_top):
        lg.info("=" * num_chars)
    lg.info(msg.center(num_chars))
    for _ in range(n_bottom):
        lg.info("=" * num_chars)

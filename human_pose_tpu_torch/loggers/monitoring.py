"""System metrics monitoring (port of human_pose_tpu/loggers/monitoring.py).

Counterpart of reference src/logger/monitoring/: a daemon-thread sampler of
the host's CPU, memory, disk and network (psutil, as the JAX package; both
machines have it) and the card's memory (``torch.cuda``), feeding a
``SystemMonitoringStorage`` that callbacks render to plots; and
``GpuInfoMonitor``, the JAX package's ``TpuInfoMonitor`` for the card (the
reference's ``NvidiaSmiMonitor``).
"""

from __future__ import annotations

import threading
import time
import traceback
from pathlib import Path

import psutil
import torch

from .pylogger import log


def collect_sample() -> dict:
    vm = psutil.virtual_memory()
    disk = psutil.disk_usage("/")
    net = psutil.net_io_counters()
    sample = {
        "timestamp": time.time(),
        "cpu_percent": psutil.cpu_percent(),
        "memory_percent": vm.percent,
        "memory_used_gb": vm.used / 1e9,
        "disk_percent": disk.percent,
        "net_sent_mb": net.bytes_sent / 1e6,
        "net_recv_mb": net.bytes_recv / 1e6,
    }
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            sample[f"gpu{i}_mem_gb"] = torch.cuda.memory_allocated(i) / 1e9
            sample[f"gpu{i}_peak_mem_gb"] = torch.cuda.max_memory_allocated(i) / 1e9
    return sample


class SystemMetricsMonitor:
    """Daemon-thread sampler (reference monitoring/base.py:9-53)."""

    def __init__(self, interval_s: float = 10.0):
        # lazy import: loggers <-> train would otherwise be circular
        from ..train.storage import SystemMonitoringStorage

        self.interval_s = interval_s
        self.storage = SystemMonitoringStorage()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.storage.append(collect_sample())
            except Exception:
                pass

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None


class GpuInfoMonitor:
    """Periodic device-memory dump to a log file, the JAX package's
    ``TpuInfoMonitor`` for the card (reference
    src/logger/monitoring/nvidia_smi.py:8-48): every ``interval_s`` seconds
    ``filepath`` is rewritten with a timestamp line and, a card, its
    memory in use by tensors, its total and the peak in use
    (``torch.cuda.memory_allocated``, ``get_device_properties(i).total_memory``,
    which ``mem_get_info`` reports too, ``max_memory_allocated``) in
    ``TpuInfoMonitor``'s format. Constructing it without a card raises: it
    never writes numbers it did not read."""

    def __init__(self, filepath: str, interval_s: float = 5.0):
        if not torch.cuda.is_available():
            raise RuntimeError("GpuInfoMonitor reads the cards' memory, and "
                               "torch.cuda.is_available() is False")
        self.filepath = filepath
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def sample(self) -> str:
        """One dump: the timestamp line and a line a card."""
        lines = [time.strftime("%Y-%m-%d %H:%M:%S")]
        for i in range(torch.cuda.device_count()):
            in_use = torch.cuda.memory_allocated(i) / 1e9
            peak = torch.cuda.max_memory_allocated(i) / 1e9
            limit = torch.cuda.get_device_properties(i).total_memory / 1e9
            lines.append(f"  {torch.cuda.get_device_name(i)} #{i}: {in_use:.2f}/{limit:.2f} GB"
                         f" (peak {peak:.2f} GB)")
        return "\n".join(lines) + "\n"

    def _loop(self) -> None:
        Path(self.filepath).parent.mkdir(parents=True, exist_ok=True)
        while not self._stop.wait(self.interval_s):
            try:
                text = self.sample()
            except RuntimeError:
                log.warning(f"GpuInfoMonitor: no sample:\n{traceback.format_exc()}")
                continue
            with open(self.filepath, "w") as f:
                f.write(text)

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

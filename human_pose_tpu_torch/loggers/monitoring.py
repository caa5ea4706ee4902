"""System metrics monitoring (port of human_pose_tpu/loggers/monitoring.py).

Counterpart of reference src/logger/monitoring/: a daemon-thread sampler of
the host's CPU, memory, disk and network (psutil, as the JAX package; both
machines have it) and the card's memory (``torch.cuda``), feeding a
``SystemMonitoringStorage`` that callbacks render to plots. The
``nvidia-smi`` monitor (the JAX package's ``TpuInfoMonitor``) is ROADMAP
module 16.
"""

from __future__ import annotations

import threading
import time

import psutil
import torch


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

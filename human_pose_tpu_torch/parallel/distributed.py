"""Process-group setup for multi-process training (port of
human_pose_tpu/parallel/distributed.py; counterpart of reference
src/base/bin/train.py:16-27, ``ddp_setup`` / ``ddp_finalize``).

The group comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; ``init_method="env://"``):
NCCL with ``torch.cuda.set_device(LOCAL_RANK)`` on the card, gloo on the
CPU. A process launched without that environment runs alone: nothing is
initialized and its rank is 0, as in the JAX package. A launch that asks
for the card and has none raises; it never falls back to the CPU or to
gloo.

    python -m torch.distributed.run --nproc_per_node=N -m human_pose_tpu_torch.bin.train_keypoints ...
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..loggers.pylogger import log

# torchrun's variables; all of them must be set for a process group
ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

# the directory that holds this package
ROOT = Path(__file__).resolve().parents[2]

# whether setup_distributed made the default group (finalize_distributed
# destroys only that one, as the JAX package's shutdown)
_initialized = False


def setup_distributed(device_type: str = "cuda") -> int:
    """Initialize the default process group from torchrun's environment
    when it is set and no group exists yet; returns this process's rank (0
    without that environment). ``device_type`` "cuda" selects NCCL on
    ``cuda:LOCAL_RANK`` (raising when there is no card), "cpu" gloo. A
    group that exists already is kept as it is."""
    global _initialized
    if dist.is_initialized():
        return dist.get_rank()
    if not all(os.environ.get(v) for v in ENV_VARS):
        return 0
    if device_type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(resolve_device(f"cuda:{local_rank}"))
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    dist.init_process_group(backend=backend, init_method="env://")
    _initialized = True
    log.info(f"initialized torch.distributed ({dist.get_backend()}): process "
             f"{dist.get_rank()} / {dist.get_world_size()}")
    return dist.get_rank()


def finalize_distributed() -> None:
    """Destroy the default process group if ``setup_distributed`` made it."""
    global _initialized
    if _initialized and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def free_port() -> int:
    """A free TCP port on 127.0.0.1, chosen by the OS."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_local(n: int, code: str) -> list[subprocess.Popen]:
    """Start ``n`` Python processes running ``code`` from the directory
    that holds this package (on their ``PYTHONPATH``), as torchrun's ranks
    0 ... n-1 of one group on 127.0.0.1 (a free port; one thread each);
    each one's output and errors merged into its ``stdout`` pipe. The
    caller waits for them and stops them."""
    port = free_port()
    procs = []
    for rank in range(n):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(n),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))}
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs

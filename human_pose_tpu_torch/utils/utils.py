"""Process rank, seeding and timers (port of human_pose_tpu/utils/utils.py).

The rank is ``torch.distributed``'s when a process group is initialized,
else the launcher's ``RANK`` environment variable (0 when unset)."""

from __future__ import annotations

import os
import random
import time
from contextlib import contextmanager
from typing import Iterator

import numpy as np
import torch


def process_group_initialized() -> bool:
    """Whether ``torch.distributed``'s default process group exists
    (``parallel.setup_distributed``)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if process_group_initialized() else int(os.environ.get("RANK", 0))


def is_main_process() -> bool:
    return get_rank() == 0


def process_count() -> int:
    """The world size of ``torch.distributed``'s process group, or 1 when
    none is initialized."""
    import torch.distributed as dist

    return dist.get_world_size() if process_group_initialized() else 1


def seed_everything(seed: int) -> None:
    """Seed python, numpy and torch's default generator (the port's own
    randomness takes explicit ``torch.Generator``s; this covers the rest)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


@contextmanager
def elapsed_timer() -> Iterator:
    """Context manager yielding a callable that returns elapsed seconds;
    the value freezes once the block exits (reference
    src/utils/utils.py:60-67, used for per-frame video latency overlays)."""
    start = time.perf_counter()
    end = [None]
    yield lambda: (end[0] if end[0] is not None else time.perf_counter()) - start
    end[0] = time.perf_counter()

"""Device-side input prefetching for the host training loop (port of
human_pose_tpu/train/prefetch.py in PyTorch's idiom).

``DevicePrefetcher`` wraps a host batch iterable and keeps ``buffer``
batches in flight on the device: batch ``i + buffer`` is sent before batch
``i`` is yielded, so its copy overlaps the step that runs on batch ``i``.
On a card each transfer runs on a side CUDA stream: the host arrays are
staged in pinned memory (when ``pin_memory`` is set), copied with
``non_blocking``, and put into the steps' NCHW layout there; an event
recorded after them is what the compute stream waits on when the batch is
yielded, and every tensor of the batch is recorded on the compute stream
(``record_stream``), so the allocator never hands its memory to another
tensor while the step still reads it. Each yielded batch is a fresh
transfer marked ``DeviceBatch``: already on the device, so the steps'
``_to_device`` and ``BaseModule.batch_to_device`` leave it as it is.

``host_batch_to_device`` is the transfer itself: the channel-last host
batch of ``data.coco.collate`` (the JAX package's arrays) to device
tensors, with the images ``[N, H, W, 3]`` and the heatmaps ``[N, h, w, K]``
permuted on the device to ``[N, 3, H, W]`` and ``[N, K, h, w]``
(``.contiguous()``): the host does no transpose.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

# batch keys whose arrays are channel-last on the host and NCHW on the device
CHANNEL_LAST_KEYS = ("images", "heatmaps")


class DeviceBatch(dict):
    """A batch already on the device, in the steps' layout (made by
    ``DevicePrefetcher``); ``BaseModule.batch_to_device`` returns it as a
    plain dict, unchanged."""


def _tensors(batch: dict):
    for value in batch.values():
        yield from (value if isinstance(value, (list, tuple)) else [value])


def host_batch_to_device(batch: dict, device: torch.device, pin_memory: bool = False) -> dict:
    """The host batch (NumPy arrays or CPU tensors; ``heatmaps`` and
    ``masks`` lists a scale) on ``device``: images and heatmaps NCHW, masks
    and joints as they are. On a card, ``pin_memory`` stages each array in
    pinned memory first and every copy is ``non_blocking`` (it runs on the
    current stream)."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def move(x, to_nchw: bool):
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
        if t.device != device:
            if cuda and pin_memory and not t.is_pinned():
                t = t.pin_memory()
            t = t.to(device, non_blocking=cuda)
        return t.permute(0, 3, 1, 2).contiguous() if to_nchw else t

    out = {}
    for key, value in batch.items():
        nchw = key in CHANNEL_LAST_KEYS
        out[key] = [move(v, nchw) for v in value] if isinstance(value, (list, tuple)) \
            else move(value, nchw)
    return out


class DevicePrefetcher:
    """Iterate ``loader``, keeping ``buffer`` device-resident batches in
    flight. ``transfer`` is typically ``module.batch_to_device``. On a CUDA
    ``device`` the transfers run on a side stream and are handed to the
    compute stream through an event; elsewhere they run inline."""

    def __init__(self, loader, transfer, buffer: int = 1, device=None):
        if buffer < 1:
            raise ValueError(f"buffer must be >= 1, got {buffer}")
        self.loader = loader
        self.transfer = transfer
        self.buffer = buffer
        self.device = None if device is None else torch.device(device)

    def __len__(self) -> int:
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __iter__(self):
        side = None
        if self.device is not None and self.device.type == "cuda":
            side = torch.cuda.Stream(self.device)

        def send(batch):
            if side is None:
                return self.transfer(batch), None
            with torch.cuda.stream(side):
                moved = self.transfer(batch)
                ready = torch.cuda.Event()
                ready.record(side)
            return moved, ready

        def receive(moved, ready) -> DeviceBatch:
            if ready is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(ready)
                for t in _tensors(moved):
                    t.record_stream(compute)
            return DeviceBatch(moved)

        pending: deque = deque()
        for batch in self.loader:
            pending.append(send(batch))
            if len(pending) > self.buffer:
                yield receive(*pending.popleft())
        while pending:
            yield receive(*pending.popleft())

"""Batched COCO keypoints evaluation (port of
human_pose_tpu/inference/batched_eval.py).

The reference evaluates val2017 one image at a time (src/keypoints/bin/
eval.py:18-49). This runner keeps the per-image math of
``InferenceKeypointsModel`` (forward, flip and multi-scale TTA, the AE
decode with its grouping and refine kernels) but:

1. **buckets** images by their input shape: the 64-aligned multi-scale input
   size is a function of the raw image size alone, so the bucket key is the
   tuple of padded input shapes over the TTA scales;
2. runs forward + decode on whole batches of one bucket, padding a partial
   batch by repeating its last image and dropping the padded outputs;
3. masks each image's own pad region with a per-image ``[B, 2]`` valid-size
   tensor, so images of several exact sizes share one ``pad_multiple``
   bucket;
4. copies only the decoded joints, scores and valid flags to the host (into
   pinned buffers, asynchronously on a card) and keeps up to two batches in
   flight, so the host prepares the next batch while the card works;
5. with a data-parallel ``mesh`` (``parallel.Mesh``: one process a device)
   evaluates the val split over several processes: each takes every
   ``world_size``-th image (``shard``) and dispatches ``batch_size //
   world_size`` of them at a time, so the global batch is ``batch_size`` as
   in the JAX package and the host work of ``prepare_input`` is split
   across the processes; ``finish`` gathers every image's record to rank 0.

Convolutions, eval-mode BatchNorm, resizes and the decode are per-image, so
the detections are the serial path's (tests/test_torch_port_eval.py,
tests/test_torch_port_sharded_eval.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..data.affine import get_multi_scale_size
from ..loggers.pylogger import log
from ..parallel.mesh import gather_to_main, require_data_mesh
from .models import InferenceKeypointsModel
from .results import InferenceKeypointsResult


@dataclass
class _Pending:
    """Host-side metadata for one image waiting in a bucket."""

    index: int  # dataset index (the order of the gathered records)
    image_id: int
    annot: list | None
    center: tuple
    scale: tuple
    valid_hw: tuple  # exact 64-aligned size at scale 1 (before bucket padding)
    xs: dict  # scale -> [H, W, 3] host input (float32 normalized, or uint8)


@dataclass
class _InFlight:
    """One dispatched batch: its host copies of (joints, scores, valid), the
    event after which they are complete (None on the CPU) and the metadata
    of its real images."""

    host: tuple
    ready: torch.cuda.Event | None
    metas: list


def image_id_from_path(path, fallback: int) -> int:
    """COCO filenames are zero-padded image ids; tolerate non-numeric stems
    (shared by the serial and batched evaluators so the id rule cannot
    diverge between them)."""
    digits = "".join(c for c in Path(path).stem if c.isdigit())
    return int(digits) if digits else fallback


def image_oks(result: InferenceKeypointsResult) -> float:
    """The result's OKS against its annotation, logged per image like the
    reference (results.py:300-304); -1 where it cannot be computed, e.g. a
    crowd annotation's RLE segmentation (no polygon area) or more annotated
    persons than detections."""
    try:
        return result.calculate_OKS()
    except (ValueError, IndexError, TypeError):
        return -1.0


def _copy_to_host(tensors: tuple) -> tuple:
    """Start the device-to-host copies of ``tensors``: on a card into pinned
    buffers, without waiting, with an event recorded after them; on the CPU
    the tensors themselves and no event."""
    dev = tensors[0].device
    if dev.type != "cuda":
        return tensors, None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors)
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(dev))
    return host, ready


class BatchedKeypointsEvaluator:
    """Batched val-split evaluation around ``InferenceKeypointsModel``.

    ``max_pending`` caps the images buffered across partly filled buckets
    (default 4 batches); when it is hit the fullest bucket is dispatched
    early as a padded partial batch. ``mesh`` (``parallel.Mesh``) shards the
    evaluation over its processes: ``batch_size`` is the global batch and
    must be a multiple of the world size; each process adds the images of
    its ``shard`` and dispatches ``local_batch_size`` at a time; the model
    is used as it is (every process built it from the same weights, and
    eval changes nothing in it). ``n_batches`` counts this process's
    dispatched batches, ``buckets`` the distinct bucket keys seen."""

    def __init__(
        self,
        model: InferenceKeypointsModel,
        batch_size: int = 8,
        mesh=None,
        max_pending: int | None = None,
        compute_oks: bool = True,
    ):
        if not hasattr(model, "decode_masked"):
            # JAX's evaluator fails on an SPPE model's missing attributes
            raise TypeError(
                f"{type(model).__name__} has no batched decode: the batched evaluator takes the "
                "bottom-up InferenceKeypointsModel only; evaluate a single-person model with "
                "--batch_size=1")
        if 1.0 not in model.scales:
            # the serial path's contract: tags and the decode geometry come
            # from the scale-1 pass
            raise ValueError(f"scales must include 1.0, got {model.scales}")
        if model.pipeline_devices:
            raise ValueError(
                "inference.pipeline_devices is for the serial/serving path; batched eval "
                "parallelizes over the data mesh (--sharded) instead — unset one of the two"
            )
        if mesh is not None:
            require_data_mesh(mesh, "the batched evaluator")
        world = 1 if mesh is None else mesh.world_size
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} not divisible by the {world}-device mesh")
        self.model = model
        self.batch_size = batch_size
        self.mesh = mesh
        self.local_batch_size = batch_size // world
        self.max_pending = 4 * self.local_batch_size if max_pending is None else max_pending
        self.compute_oks = compute_oks
        self._buckets: dict = {}
        self._in_flight: list = []
        self._records: list = []  # (dataset index, detections, OKS or None) an image
        self._n_added = 0
        self._n_images = 0
        self.n_batches = 0
        self.buckets: set = set()

    # -- bucket key ---------------------------------------------------------

    def _scales(self) -> tuple:
        return tuple(sorted(self.model.scales, reverse=True))

    def _padded_hw(self, raw_hw: tuple, current_scale: float) -> tuple:
        """Input (h, w) of the model for one TTA scale: a function of the raw
        image size alone (no pixel work)."""
        m = self.model
        (w, h), _, _ = get_multi_scale_size(
            np.empty((*raw_hw, 0)), m.input_size, current_scale, min(m.scales)
        )
        if m.pad_multiple > 64:
            p = m.pad_multiple
            h, w = -(-h // p) * p, -(-w // p) * p
        return (h, w)

    def _bucket_key(self, raw_hw: tuple) -> tuple:
        return tuple(self._padded_hw(raw_hw, s) for s in self._scales())

    # -- device work --------------------------------------------------------

    def _dispatch(self, key: tuple) -> None:
        metas = self._buckets.pop(key)
        m = self.model
        pad = self.local_batch_size - len(metas)
        scales = self._scales()
        hw = key[scales.index(1.0)]

        valid_hw = torch.tensor([p.valid_hw for p in metas] + [metas[-1].valid_hw] * pad,
                                dtype=torch.int32).to(m.device, non_blocking=True)
        avg_sum = tags_list = None
        for s in scales:
            xs = np.stack([p.xs[s] for p in metas] + [metas[-1].xs[s]] * pad)
            avg, tags_s = m.forward_scale(m.to_device(xs), hw)
            avg_sum = avg if avg_sum is None else avg_sum + avg
            if s == 1.0:
                tags_list = tags_s
        joints, scores, valid, _ = m.decode_masked(avg_sum, tags_list, hw, float(len(scales)),
                                                   valid_hw)
        # outputs stay on the device until their copies land; the host
        # prepares the next batch meanwhile, with at most two in flight
        self._in_flight.append(_InFlight(*_copy_to_host((joints, scores, valid)), metas))
        self.n_batches += 1
        self._drain(keep=2)
        for p in metas:
            p.xs = {}  # release pixel buffers immediately

    def _drain(self, keep: int = 0) -> None:
        while len(self._in_flight) > keep:
            out = self._in_flight.pop(0)
            if out.ready is not None:
                out.ready.synchronize()
            joints, scores, valid = (t.numpy() for t in out.host)
            for i, meta in enumerate(out.metas):
                vh, vw = meta.valid_hw
                res = InferenceKeypointsResult.from_decoded(
                    raw_image=None,
                    annot=meta.annot,
                    # only .shape[:2] is read (the inverse affine's output
                    # size); eval never plots, so no map reaches the host
                    model_input_image=np.zeros((vh, vw, 0), np.float32),
                    avg_heatmaps=np.zeros((1, 1, 1), np.float32),
                    tags_heatmaps=np.zeros((1, 1, 1, 1), np.float32),
                    joints=joints[i],
                    obj_scores=scores[i],
                    valid=valid[i],
                    center=meta.center,
                    scale=meta.scale,
                    det_thr=self.model.det_thr,
                    tag_thr=self.model.tag_thr,
                    limbs=self.model.limbs,
                )
                oks = None
                if self.compute_oks and meta.annot is not None:
                    oks = image_oks(res)
                self._records.append((meta.index, res.to_coco_detections(meta.image_id), oks))
                self._n_images += 1

    # -- public API ---------------------------------------------------------

    def shard(self, n: int) -> range:
        """The dataset indices of ``range(n)`` this process evaluates: every
        ``world_size``-th from its rank (all of them without a mesh)."""
        if self.mesh is None:
            return range(n)
        return range(self.mesh.rank, n, self.mesh.world_size)

    def add(self, image: np.ndarray, image_id: int, annot: list | None = None,
            index: int | None = None) -> None:
        """Queue one image. ``index`` is its dataset index, the order of
        ``finish``'s records (default: the count of images added before);
        under a mesh it is required and must be of this process's
        ``shard``."""
        if self.mesh is not None and (index is None or index % self.mesh.world_size != self.mesh.rank):
            raise ValueError(f"index {index} is not of rank {self.mesh.rank}'s shard (every "
                             f"{self.mesh.world_size}-th image from {self.mesh.rank})")
        if index is None:
            index = self._n_added
        self._n_added += 1
        m = self.model
        scales = self._scales()
        min_scale = min(scales)
        xs = {}
        for s in scales:
            x, c, sc = m.prepare_input(image, s, min_scale)
            xs[s] = x[0]
            if s == 1.0:
                center, scale_wh = c, sc
                (w1, h1), _, _ = get_multi_scale_size(image, m.input_size, 1.0, min_scale)
                valid_hw = (h1, w1)
        key = self._bucket_key(image.shape[:2])
        self.buckets.add(key)
        self._buckets.setdefault(key, []).append(
            _Pending(index, image_id, annot, center, scale_wh, valid_hw, xs)
        )
        if len(self._buckets[key]) == self.local_batch_size:
            self._dispatch(key)
        elif sum(len(v) for v in self._buckets.values()) >= self.max_pending:
            fullest = max(self._buckets, key=lambda k: len(self._buckets[k]))
            self._dispatch(fullest)

    def finish(self) -> tuple[list[dict], list[float]]:
        """Flush partial buckets and drain all in-flight batches; returns the
        detections and the per-image OKS values. Without a mesh they are in
        the order the batches were drained. Under a mesh every process's
        records are gathered to rank 0, which returns them in dataset order;
        the other ranks return empty lists."""
        for key in sorted(self._buckets, key=lambda k: -len(self._buckets[k])):
            self._dispatch(key)
        self._drain(keep=0)
        records = self._records
        if self.mesh is not None:
            gathered = gather_to_main(self.mesh, records)
            if gathered is None:
                return [], []
            records = sorted((r for part in gathered for r in part), key=lambda r: r[0])
        detections = [d for _, dets, _ in records for d in dets]
        oks_values = [oks for _, _, oks in records if oks is not None and oks >= 0]
        return detections, oks_values


def evaluate_dataset_batched(
    model: InferenceKeypointsModel,
    ds,
    batch_size: int,
    limit: int = -1,
    mesh=None,
    progress: bool = True,
) -> list[dict]:
    """Batched counterpart of ``bin.eval_keypoints.evaluate_dataset``: the
    same detections and per-image OKS logging, batched device work. Under
    ``mesh`` each process reads and evaluates its shard of the images, and
    rank 0 returns every image's detections in dataset order (the other
    ranks an empty list)."""
    from tqdm.auto import tqdm

    runner = BatchedKeypointsEvaluator(model, batch_size=batch_size, mesh=mesh)
    n = len(ds) if limit <= 0 else min(limit, len(ds))
    mine = runner.shard(n)
    t0 = time.perf_counter()
    it = tqdm(mine, desc=f"evaluating (batched bs{batch_size})") if progress else mine
    for idx in it:
        image = ds.load_image(idx)
        annot = ds.load_annot(idx)
        image_id = image_id_from_path(ds.images_filepaths[idx], fallback=idx)
        runner.add(image, image_id, annot, index=idx)
    detections, oks_values = runner.finish()
    dt = time.perf_counter() - t0
    if oks_values:
        log.info(f"mean image OKS over {len(oks_values)} images: {np.mean(oks_values):.4f}")
    here = f"; {len(mine)} in this process" if mesh is not None else ""
    log.info(f"batched eval: {n} images in {dt:.1f}s ({n / dt:.1f} img/s{here}), "
             f"{runner.n_batches} batches over {len(runner.buckets)} buckets")
    return detections

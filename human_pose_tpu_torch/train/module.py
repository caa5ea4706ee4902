"""Task modules: a model, its train state, its steps and its schedulers
(port of human_pose_tpu/train/module.py).

``BaseModule.create`` builds the state from the yaml's ``module.optimizers``
and ``module.lr_schedulers`` dicts (one ``optim`` entry each) through the
port's ``create_optimizer`` and ``create_lr_scheduler``, after the task's
init on a ``torch.Generator`` seeded from ``seed`` (the JAX package's
``PRNGKey`` stream is not reproduced, only the distribution). The learning
rate of each step is the first scheduler's; schedulers with ``interval``
"step" move after every training step, "epoch" ones at the epoch's end.

``batch_to_device`` takes the host batch of ``data.coco.collate``
(channel-last, the JAX package's arrays) to the state's device in the
steps' NCHW layout (``train/prefetch.py::host_batch_to_device``); a
``DeviceBatch`` from ``DevicePrefetcher`` is already there.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models import init_keypoints_weights_
from .optim import LRScheduler, create_lr_scheduler, create_optimizer
from .prefetch import DeviceBatch, host_batch_to_device
from .state import TrainState
from .steps import accumulated_keypoints_train_step, keypoints_train_step, keypoints_val_step

# the JAX package's val-time decode thresholds (reference keypoints/module.py:95-99)
VAL_DET_THR, VAL_TAG_THR = 0.1, 1.0


class BaseModule:
    name: str = "base"

    def __init__(self, model, state: TrainState, schedulers: dict[str, LRScheduler],
                 accumulate_grad_batches: int = 1, pin_memory: bool = False):
        self.model = model
        self.state = state
        self.schedulers = schedulers
        # > 1: each batch is split into that many microbatches whose
        # gradients are averaged before one update (train/steps.py)
        self.accumulate_grad_batches = accumulate_grad_batches
        # stage host batches in pinned memory before their copy to the card
        self.pin_memory = pin_memory

    # -- factory -------------------------------------------------------------
    @classmethod
    def create(cls, model, optimizers_cfg: dict, lr_schedulers_cfg: dict, seed: int = 42,
               init_weights: Callable | None = None, mesh=None, accumulate_grad_batches: int = 1,
               dtype: torch.dtype = torch.float32, pin_memory: bool = False) -> "BaseModule":
        """The module of ``model`` (already on its device), its weights from
        ``init_weights(model, generator)`` and its optimizer and schedulers
        from dicts shaped like the yaml's. ``dtype`` is the compute dtype
        (float32, or bfloat16 under autocast)."""
        if mesh is not None:
            raise NotImplementedError("a device mesh comes with the port's parallelism, "
                                      "ROADMAP module 14")
        if init_weights is not None:
            init_weights(model, torch.Generator().manual_seed(seed))
        opt_cfg = optimizers_cfg["optim"]
        params = dict(opt_cfg.get("params") or {})
        lr = float(params.pop("lr", 1e-3))
        # torch's betas tuple arrives as a list from yaml
        if "betas" in params:
            params["betas"] = tuple(params["betas"])
        optimizer = create_optimizer(model.parameters(), opt_cfg["name"], lr, **params)
        device = next(model.parameters()).device
        state = TrainState.create(model, optimizer, dtype=dtype, device=device)
        schedulers = {}
        for key, sch in (lr_schedulers_cfg or {}).items():
            schedulers[key] = create_lr_scheduler(
                lr, sch["name"], sch.get("interval", "epoch"), **(sch.get("params") or {}))
        if not schedulers:
            schedulers["optim"] = create_lr_scheduler(lr, "ConstantLR")
        return cls(model, state, schedulers, accumulate_grad_batches=accumulate_grad_batches,
                   pin_memory=pin_memory)

    # -- lr ------------------------------------------------------------------
    @property
    def lr(self) -> float:
        return next(iter(self.schedulers.values())).lr

    def on_step_end(self) -> None:
        for s in self.schedulers.values():
            if s.interval == "step":
                s.step()

    def on_epoch_end(self, val_metrics: dict | None = None) -> None:
        for s in self.schedulers.values():
            if s.interval == "epoch":
                metric = None
                if val_metrics is not None:
                    metric = val_metrics.get("loss")
                s.step(metric)

    # -- device placement ----------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.state.device

    def batch_to_device(self, batch: dict) -> dict:
        """The batch on the state's device in the steps' layout; a
        ``DeviceBatch`` is there already and comes back as a plain dict."""
        if isinstance(batch, DeviceBatch):
            return dict(batch)
        return host_batch_to_device(batch, self.device, pin_memory=self.pin_memory)

    # -- steps (overridden) ----------------------------------------------------
    def training_step(self, batch: dict) -> dict:
        raise NotImplementedError

    def validation_step(self, batch: dict):
        raise NotImplementedError

    # -- checkpoint ------------------------------------------------------------
    def schedulers_state_dict(self) -> dict:
        return {k: s.state_dict() for k, s in self.schedulers.items()}

    def load_schedulers_state_dict(self, state: dict) -> None:
        for k, st in state.items():
            if k in self.schedulers:
                self.schedulers[k].load_state_dict(st)


class ClassificationModule(BaseModule):
    name = "classification"

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("the classification module comes with the port's classification "
                                  "model, ROADMAP module 12")


class KeypointsModule(BaseModule):
    name = "keypoints"

    @classmethod
    def create(cls, model, optimizers_cfg=None, lr_schedulers_cfg=None, seed=42, mesh=None,
               **kw) -> "KeypointsModule":
        """Adam at lr 1e-3 unless the dicts say otherwise; the keypoints init
        (``init_keypoints_weights_``)."""
        return super().create(
            model,
            optimizers_cfg or {"optim": {"name": "Adam", "params": {"lr": 1e-3}}},
            lr_schedulers_cfg or {},
            seed=seed, init_weights=init_keypoints_weights_, mesh=mesh, **kw,
        )

    def training_step(self, batch: dict) -> dict:
        batch = self.batch_to_device(batch)
        if self.accumulate_grad_batches > 1:
            step = accumulated_keypoints_train_step(self.accumulate_grad_batches)
        else:
            step = keypoints_train_step
        self.state, metrics = step(self.state, batch, self.lr)
        self.on_step_end()
        return metrics

    def validation_step(self, batch: dict):
        batch = self.batch_to_device(batch)
        metrics, outputs = keypoints_val_step(self.state, batch)
        return metrics, outputs

    def make_results(self, batch: dict, outputs, max_results: int = 4) -> list:
        """Decode one val batch into plottable results at the val-time
        thresholds (det 0.1, tag 1.0) through the port's ``decode_batch``
        (on a card: its refine and grouping kernels, one launch each).
        ``batch`` is the host batch the val step took (channel-last) or a
        ``DeviceBatch`` (NCHW)."""
        from ..inference.results import KeypointsResult
        from ..ops.decode import decode_batch
        from ..ops.heatmaps import average_stages, resize_bilinear

        stages_hms, tags = outputs
        n = min(max_results, stages_hms[0].shape[0])
        stages_hms = [h[:n].float() for h in stages_hms]
        tags = tags[:n].float()
        images = batch["images"]
        if isinstance(batch, DeviceBatch):
            images = images.permute(0, 2, 3, 1)
        images = images.cpu().numpy() if torch.is_tensor(images) else np.asarray(images)
        h, w = images.shape[1:3]
        joints, scores, valid = decode_batch(
            stages_hms, [tags], input_hw=(h, w), max_num_people=batch["joints"].shape[1],
            det_thr=VAL_DET_THR, tag_thr=VAL_TAG_THR,
        )
        avg = resize_bilinear(average_stages(stages_hms), h, w).permute(0, 2, 3, 1).cpu().numpy()
        tags_big = resize_bilinear(tags, h, w).permute(0, 2, 3, 1).cpu().numpy()
        joints, scores, valid = joints.cpu().numpy(), scores.cpu().numpy(), valid.cpu().numpy()
        results = []
        for i in range(n):
            v, j = valid[i], joints[i]
            results.append(KeypointsResult(
                model_input_image=images[i],
                kpts_heatmaps=avg[i],
                tags_heatmaps=tags_big[i],
                kpts_coords=j[v][..., :2],
                kpts_scores=j[v][..., 2],
                kpts_tags=j[v][..., 3:],
                obj_scores=scores[i][v],
                det_thr=VAL_DET_THR,
            ))
        return results


def metrics_to_host(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}

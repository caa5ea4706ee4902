"""Keypoints task config (port of human_pose_tpu/configs/keypoints.py;
counterpart of reference src/keypoints/config.py): the network, the
inference model, the training datamodule (COCO datasets, transforms,
loaders) and the training module from a yaml."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..loggers.pylogger import log
from .base import BaseConfig, TransformConfig, process_count

ARCHITECTURES = ("HigherHRNet", "Hourglass", "SimpleBaseline", "HRNet")
# the single-person nets: trained on person crops (data/coco_topdown.py)
TOP_DOWN_ARCHITECTURES = ("SimpleBaseline", "HRNet")
# the JAX model's layout switch (space-to-depth, a TPU lane packing): the
# same parameters and the same forward, so the port drops it
JAX_ONLY_NET_PARAMS = ("s2d",)


@dataclass
class KeypointsTransformConfig(TransformConfig):
    out_size: int = 512
    hm_resolutions: list = field(default_factory=lambda: [0.25, 0.5])
    max_rotation: float = 30
    min_scale: float = 0.7
    max_scale: float = 1.6
    scale_type: str = "short"
    max_translate: int = 40


@dataclass
class KeypointsConfig(BaseConfig):
    transform: KeypointsTransformConfig = field(default_factory=KeypointsTransformConfig)

    def create_net(self, bn_groups: int = 1, world_size: int = 1, device=None):
        """The port's network for ``setup.architecture`` (default
        HigherHRNet; Hourglass is the AE hourglass, SimpleBaseline and HRNet
        the single-person models) from ``net.params``, on ``device``
        (default ``target_device()``), weights not yet loaded; its BatchNorm
        scope is ``bn_groups`` groups of a global batch split over
        ``world_size`` processes (``models/norm.py::convert_batch_norm``)."""
        from .. import models
        from ..models.norm import convert_batch_norm

        arch = self.setup.architecture or "HigherHRNet"
        params = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in dict(self.net.params).items() if k not in JAX_ONLY_NET_PARAMS}
        device = device or self.target_device()
        if arch == "HigherHRNet":
            net = models.HigherHRNet(**params, device=device)
        elif arch == "Hourglass":
            net = models.AEHourglassNet(num_kpts=params.get("num_kpts", 17),
                                        num_stages=params.get("num_stages", 2), device=device)
        elif arch == "SimpleBaseline":
            net = models.SimpleBaseline(num_kpts=params.get("num_kpts", 17),
                                        backbone=params.get("backbone", "resnet50"), device=device)
        elif arch == "HRNet":
            params["num_keypoints"] = params.pop("num_kpts", 17)
            net = models.HRNetSPPE(**params, device=device)
        else:
            raise ValueError(f"unknown keypoints architecture {arch!r} "
                             f"(expected one of {ARCHITECTURES})")
        return convert_batch_norm(net, bn_groups, world_size)

    def _make_transform(self):
        """``KeypointsTransform`` from the ``transform`` section; compact
        batches leave the image uint8 and normalize on the device with the
        ImageNet constants, so they refuse another mean or std."""
        from ..data.transforms import KeypointsTransform

        t = self.transform
        if self.dataloader.compact_batches and (
            list(t.mean) != [0.485, 0.456, 0.406] or list(t.std) != [0.229, 0.224, 0.225]
        ):
            raise ValueError(
                "dataloader.compact_batches requires the default ImageNet mean/std — the "
                "device-side normalize (ops/images.py::prep_images) uses those constants"
            )
        return KeypointsTransform(
            normalize=not self.dataloader.compact_batches,
            out_size=t.out_size,
            hm_resolutions=t.hm_resolutions,
            max_rotation=t.max_rotation,
            min_scale=t.min_scale,
            max_scale=t.max_scale,
            scale_type=t.scale_type,
            max_translate=t.max_translate,
            mean=t.mean,
            std=t.std,
        )

    @property
    def top_down(self) -> bool:
        """A single-person net, trained on person crops."""
        return self.setup.architecture in TOP_DOWN_ARCHITECTURES

    def create_datamodule(self):
        """COCO train and val datasets with the train and inference
        transforms (the single-person nets: person crops,
        ``data/coco_topdown.py``, augmented as the source on the train
        split, the GT box's crop alone on the val split), and their
        loaders (the train one shuffled), sharded over
        ``torch.distributed``'s processes when a group is initialized."""
        from ..data.coco import CocoKeypointsDataset, collate
        from ..data.coco_topdown import CocoTopDownDataset, collate_topdown
        from ..data.loader import DataLoader
        from ..train.trainer import DataModule
        from ..utils.utils import get_rank

        dl_cfg = self.dataloader
        if self.top_down:  # crops of out_size rows, 3/4 of that in columns; targets at 1/4
            train_ds, val_ds = (
                CocoTopDownDataset(ds.root, ds.split, out_size=ds.out_size,
                                   hm_resolution=float(ds.hm_resolutions[0]),
                                   num_kpts=ds.num_kpts, sigma=ds.sigma, augment=augment)
                for ds, augment in ((dl_cfg.train_ds, True), (dl_cfg.val_ds, False)))
        else:
            t = self._make_transform()
            common = dict(
                out_size=dl_cfg.train_ds.out_size,
                hm_resolutions=dl_cfg.train_ds.hm_resolutions,
                num_kpts=dl_cfg.train_ds.num_kpts,
                max_num_people=dl_cfg.train_ds.max_num_people,
                sigma=dl_cfg.train_ds.sigma,
                compact=dl_cfg.compact_batches,
            )
            train_ds = CocoKeypointsDataset(
                dl_cfg.train_ds.root, dl_cfg.train_ds.split, t.train,
                mosaic_probability=dl_cfg.train_ds.mosaic_probability, **common,
            )
            val_ds = CocoKeypointsDataset(dl_cfg.val_ds.root, dl_cfg.val_ds.split, t.inference,
                                          **common)
        kw = dict(
            batch_size=dl_cfg.batch_size,
            collate_fn=collate_topdown if self.top_down else collate,
            num_workers=dl_cfg.num_workers,
            seed=self.setup.seed,
            process_index=get_rank(),
            process_count=process_count(),
        )
        train_dl = DataLoader(train_ds, shuffle=True, **kw) if len(train_ds) else None
        val_dl = DataLoader(val_ds, shuffle=False, drop_last=False, **kw) if len(val_ds) else None
        if train_dl is None:
            log.warning("empty train dataset — datamodule has no train loader")
        return DataModule(train_dl, val_dl, train_ds, val_ds)

    def stage_resolutions(self) -> tuple:
        """The heatmap stages' resolutions, as fractions of the input, of a
        network ``KeypointsModule`` trains: HigherHRNet's 1/4 and 1/2, the
        AE hourglass's 1/4 for each of its ``num_stages``, the single-person
        nets' one stage at 1/4."""
        arch = self.setup.architecture or "HigherHRNet"
        if arch == "Hourglass":
            return (0.25,) * int(self.net.params.get("num_stages", 2))
        return (0.25, 0.5) if arch == "HigherHRNet" else (0.25,)

    def check_trainable(self) -> None:
        """Refuse targets the network cannot train on, before anything is
        built: an ``hm_resolutions`` entry of ``dataloader.train_ds``,
        ``val_ds`` or ``transform`` (the masks' sizes) that is not the
        matching stage's resolution (JAX fails later, in the loss, with a
        broadcast error)."""
        stages = self.stage_resolutions()
        for name, section in (("dataloader.train_ds", self.dataloader.train_ds),
                              ("dataloader.val_ds", self.dataloader.val_ds),
                              ("transform", self.transform)):
            res = list(section.hm_resolutions)
            if any(float(r) != s for r, s in zip(res, stages)):
                raise ValueError(f"{name}.hm_resolutions {res}: the "
                                 f"{self.setup.architecture or 'HigherHRNet'} net's heatmap stages "
                                 f"are at {list(stages)} of the input, and each target must match "
                                 "its stage")

    def create_module(self, mesh=None, device=None):
        """``KeypointsModule`` on the network (on ``device``, default the
        mesh's or ``target_device()``), in ``compute_dtype()``, with the
        BatchNorm scope of ``bn_groups(mesh)`` over the mesh's processes,
        the keypoints init seeded from ``setup.seed`` and the yaml's
        optimizer and schedulers; host batches staged in pinned memory when
        ``dataloader.pin_memory`` is set. HigherHRNet and the AE hourglass
        train through the AE steps, the single-person nets through the
        top-down steps (``check_trainable`` first)."""
        from ..train.module import KeypointsModule

        self.check_trainable()
        model = self.create_net(bn_groups=self.bn_groups(mesh),
                                world_size=mesh.world_size if mesh else 1,
                                device=device or (mesh.device if mesh else None))
        return KeypointsModule.create(
            model,
            optimizers_cfg=unstruct_optims(self.module.optimizers),
            lr_schedulers_cfg=unstruct_optims(self.module.lr_schedulers),
            seed=self.setup.seed,
            mesh=mesh,
            accumulate_grad_batches=self.module.accumulate_grad_batches,
            dtype=self.compute_dtype(),
            pin_memory=self.dataloader.pin_memory,
        )

    def create_inference_model(self, ckpt_path: str | None = None, device=None):
        """The inference model on the network: ``InferenceSPPEModel`` for
        the single-person architectures (HRNet, SimpleBaseline: no AE tags,
        the argmax decode), ``InferenceKeypointsModel`` otherwise; weights
        from ``ckpt_path`` or ``inference.ckpt_path`` (a flax npz or a
        reference ``.pt``, ``load_inference_weights``); without one, seeded
        random weights (``init_flax_default_``, seed 0, as JAX's
        ``PRNGKey(0)``) and a warning."""
        from ..inference.models import (
            InferenceKeypointsModel, InferenceSPPEModel, load_inference_weights,
        )
        from ..models import init_flax_default_

        net = self.create_net(device=device)
        ckpt = ckpt_path or self.inference.ckpt_path
        if ckpt:
            net.load_state_dict(load_inference_weights(ckpt))
        else:
            log.warning("no inference ckpt_path given — using random weights")
            init_flax_default_(net, torch.Generator().manual_seed(0))
        net.eval()
        device = next(net.parameters()).device
        if (self.setup.architecture or "HigherHRNet") in ("HRNet", "SimpleBaseline"):
            return InferenceSPPEModel(
                net,
                det_thr=self.inference.det_thr,
                input_size=self.inference.input_size,
                compact_inputs=self.inference.compact_inputs,
                dtype=self.compute_dtype(),
                device=device,
            )
        return InferenceKeypointsModel(
            net,
            det_thr=self.inference.det_thr,
            tag_thr=self.inference.tag_thr,
            use_flip=self.inference.use_flip,
            input_size=self.inference.input_size,
            pad_multiple=self.resolved_pad_multiple(),
            scales=tuple(self.inference.scales or (1.0,)),
            pipeline_devices=self.inference.pipeline_devices,
            compact_inputs=self.inference.compact_inputs,
            dtype=self.compute_dtype(),
            device=device,
        )


def unstruct_optims(cfg: dict) -> dict:
    """``module.optimizers`` / ``module.lr_schedulers`` arrive as plain
    dicts from yaml; passed through unchanged."""
    return cfg or {}

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
# the JAX model's layout (space-to-depth) and rematerialization switches:
# the same parameters and the same forward, so the port drops them
JAX_ONLY_NET_PARAMS = ("s2d", "remat")


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

    def compute_dtype(self) -> torch.dtype:
        """The JAX package's rule for the same yaml: bfloat16 where
        ``trainer.accelerator`` is "tpu" (every yaml of the repo), else
        float32."""
        return torch.bfloat16 if self.trainer.accelerator == "tpu" else torch.float32

    def target_device(self) -> str:
        """The CPU only when ``trainer.accelerator`` is "cpu"; the card
        otherwise."""
        return "cpu" if self.trainer.accelerator == "cpu" else "cuda"

    def create_net(self, bn_groups: int = 1, device=None):
        """The port's network for ``setup.architecture`` (default
        HigherHRNet) from ``net.params``, on ``device`` (default
        ``target_device()``), weights not yet loaded."""
        from ..models import HigherHRNet

        if bn_groups != 1:
            raise NotImplementedError("bn_groups > 1 (per-device BatchNorm statistics) comes with "
                                      "the port's parallelism, ROADMAP module 14")
        arch = self.setup.architecture or "HigherHRNet"
        if arch in ("Hourglass", "SimpleBaseline", "HRNet"):
            raise NotImplementedError(f"architecture {arch!r} comes with the port's model zoo, "
                                      "ROADMAP module 15")
        if arch != "HigherHRNet":
            raise ValueError(f"unknown keypoints architecture {arch!r} "
                             f"(expected one of {ARCHITECTURES})")
        params = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in dict(self.net.params).items() if k not in JAX_ONLY_NET_PARAMS}
        return HigherHRNet(**params, device=device or self.target_device())

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

    def create_datamodule(self):
        """COCO train and val datasets with the train and inference
        transforms, and their loaders (the train one shuffled), sharded over
        ``torch.distributed``'s processes when a group is initialized."""
        from ..data.coco import CocoKeypointsDataset, collate
        from ..data.loader import DataLoader
        from ..train.trainer import DataModule
        from ..utils.utils import get_rank

        t = self._make_transform()
        dl_cfg = self.dataloader
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
        val_ds = CocoKeypointsDataset(dl_cfg.val_ds.root, dl_cfg.val_ds.split, t.inference, **common)
        kw = dict(
            batch_size=dl_cfg.batch_size,
            collate_fn=collate,
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

    def create_module(self, mesh=None, device=None):
        """``KeypointsModule`` on the network (on ``device``, default
        ``target_device()``), in ``compute_dtype()``, with the keypoints
        init seeded from ``setup.seed`` and the yaml's optimizer and
        schedulers; host batches staged in pinned memory when
        ``dataloader.pin_memory`` is set."""
        from ..train.module import KeypointsModule

        model = self.create_net(bn_groups=self.bn_groups(mesh), device=device)
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
        """``InferenceKeypointsModel`` on the network, weights from
        ``ckpt_path`` or ``inference.ckpt_path`` (a flax npz or a reference
        ``.pt``, ``load_inference_weights``); without one, seeded random
        weights (``init_flax_default_``, seed 0, as JAX's ``PRNGKey(0)``)
        and a warning."""
        from ..inference.models import InferenceKeypointsModel, load_inference_weights
        from ..models import init_flax_default_

        net = self.create_net(device=device)
        ckpt = ckpt_path or self.inference.ckpt_path
        if ckpt:
            net.load_state_dict(load_inference_weights(ckpt))
        else:
            log.warning("no inference ckpt_path given — using random weights")
            init_flax_default_(net, torch.Generator().manual_seed(0))
        net.eval()
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
            device=next(net.parameters()).device,
        )


def unstruct_optims(cfg: dict) -> dict:
    """``module.optimizers`` / ``module.lr_schedulers`` arrive as plain
    dicts from yaml; passed through unchanged."""
    return cfg or {}

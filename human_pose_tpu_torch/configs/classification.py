"""Classification task config (port of human_pose_tpu/configs/classification.py;
counterpart of reference src/classification/config.py): the network, the
ImageNet datamodule (ImageFolder datasets, crops, loaders), the training
module and the inference model from a yaml."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..loggers.pylogger import log
from .base import BaseConfig, TransformConfig, process_count
from .keypoints import unstruct_optims


@dataclass
class ClassificationTransformConfig(TransformConfig):
    out_size: int = 224


@dataclass
class ClassificationConfig(BaseConfig):
    transform: ClassificationTransformConfig = field(default_factory=ClassificationTransformConfig)

    def create_net(self, bn_groups: int = 1, world_size: int = 1, device=None):
        """``ClassificationHRNet`` from ``net.params`` on ``device`` (default
        ``target_device()``), weights not yet loaded; its BatchNorm scope is
        ``bn_groups`` groups of a global batch split over ``world_size``
        processes (``models/norm.py::convert_batch_norm``)."""
        from ..models import ClassificationHRNet
        from ..models.norm import convert_batch_norm

        params = {k: tuple(v) if isinstance(v, list) else v for k, v in dict(self.net.params).items()}
        net = ClassificationHRNet(**params, device=device or self.target_device())
        return convert_batch_norm(net, bn_groups, world_size)

    def _out_size(self) -> int:
        s = self.transform.out_size
        return s[0] if isinstance(s, (list, tuple)) else int(s)

    def create_datamodule(self):
        """ImageNet train and val datasets (random resized crops and flips;
        the center crop) and their loaders (the train one shuffled), sharded
        over ``torch.distributed``'s processes when a group is initialized;
        a split directory that does not exist gives a datamodule without
        loaders and a warning, as in the JAX package."""
        from ..data.imagenet import ImagenetClassificationDataset, collate_classification
        from ..data.loader import DataLoader
        from ..data.transforms import ClassificationTransform
        from ..train.trainer import DataModule
        from ..utils.utils import get_rank

        t = ClassificationTransform(out_size=self._out_size(),
                                    normalize=not self.dataloader.compact_batches)
        dl_cfg = self.dataloader
        try:
            train_ds = ImagenetClassificationDataset(dl_cfg.train_ds.root, dl_cfg.train_ds.split,
                                                     t.train)
            val_ds = ImagenetClassificationDataset(dl_cfg.val_ds.root, dl_cfg.val_ds.split,
                                                   t.inference)
        except FileNotFoundError as e:
            log.warning(f"dataset unavailable: {e}")
            return DataModule(None, None)
        kw = dict(
            batch_size=dl_cfg.batch_size,
            collate_fn=collate_classification,
            num_workers=dl_cfg.num_workers,
            seed=self.setup.seed,
            process_index=get_rank(),
            process_count=process_count(),
        )
        train_dl = DataLoader(train_ds, shuffle=True, **kw)
        val_dl = DataLoader(val_ds, shuffle=False, drop_last=False, **kw)
        return DataModule(train_dl, val_dl, train_ds, val_ds)

    def create_module(self, mesh=None, device=None):
        """``ClassificationModule`` on the network (on ``device``, default
        ``target_device()``), in ``compute_dtype()``, with the
        classification init seeded from ``setup.seed`` and the yaml's
        optimizer and schedulers (SGD at lr 0.1 when it names none)."""
        from ..train.module import ClassificationModule

        model = self.create_net(bn_groups=self.bn_groups(mesh),
                                world_size=mesh.world_size if mesh else 1,
                                device=device or (mesh.device if mesh else None))
        return ClassificationModule.create(
            model,
            optimizers_cfg=unstruct_optims(self.module.optimizers),
            lr_schedulers_cfg=unstruct_optims(self.module.lr_schedulers),
            seed=self.setup.seed,
            mesh=mesh,
            accumulate_grad_batches=self.module.accumulate_grad_batches,
            dtype=self.compute_dtype(),
            pin_memory=self.dataloader.pin_memory,
        )

    def create_inference_model(self, ckpt_path: str | None = None, labels=None, device=None):
        """``InferenceClassificationModel`` on the network, weights from
        ``ckpt_path`` or ``inference.ckpt_path`` (the port's ``last.pt``, a
        flax npz or a reference ``.pt``, ``load_inference_weights``);
        without one, seeded random weights (``init_flax_default_``, seed 0,
        as JAX's ``PRNGKey(0)``) and a warning."""
        from ..inference.models import InferenceClassificationModel, load_inference_weights
        from ..models import init_flax_default_

        net = self.create_net(device=device)
        ckpt = ckpt_path or self.inference.ckpt_path
        if ckpt:
            net.load_state_dict(load_inference_weights(ckpt))
        else:
            log.warning("no inference ckpt_path given — using random weights")
            init_flax_default_(net, torch.Generator().manual_seed(0))
        net.eval()
        return InferenceClassificationModel(
            net, labels=labels, input_size=self.inference.input_size,
            compact_inputs=self.inference.compact_inputs, dtype=self.compute_dtype(),
            device=next(net.parameters()).device,
        )

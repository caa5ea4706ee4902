"""Keypoints task config (port of human_pose_tpu/configs/keypoints.py;
counterpart of reference src/keypoints/config.py): the network and the
inference model from a yaml. The datamodule and the training module come
with ROADMAP module 10."""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..loggers.pylogger import log
from .base import BaseConfig, TransformConfig

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

"""The inference models: host preprocess + device forward (and decode)
(port of ``InferenceKeypointsModel``, ``InferenceSPPEModel`` and
``InferenceClassificationModel`` of human_pose_tpu/inference/models.py).

Counterpart of reference src/keypoints/model.py:43-111: 64-aligned resize,
flip and multi-scale TTA, the AE decode, the inverse affine back to the raw
image. The forward, the flip forward, the stage aggregation, the resizes and
the decode run on the model's device (the decode's grouping and refine as
the CUDA kernels of ``ops`` on a card); the host prepares the input and
receives what the result object needs. The single-person model decodes
one person an image by argmax (``ops/sppe.py``) on the device. The classification model resizes
and center-crops on the host and runs the forward and the softmax on the
device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from ..constants import PAD_PIXEL_U8
from ..data.affine import resize_align_multi_scale
from ..data.coco import COCO_LIMBS
from ..data.transforms import ClassificationTransform, inverse_normalize, normalize
from ..device import constant, resolve_device
from ..ops.decode import decode_batch
from ..ops.flip import flip_back, merge_flip_heatmaps
from ..ops.heatmaps import average_stages, resize_bilinear
from ..ops.images import prep_images
from ..ops.sppe import sppe_parse
from ..utils.profiling import span
from ..utils.weights import read_state_dict
from .results import ClassificationResult, InferenceKeypointsResult


def load_inference_weights(path: str | Path) -> dict[str, torch.Tensor]:
    """A reference-layout float32 state dict, for ``load_state_dict(strict=True)``
    of the port's model, from:

    * a flax npz (flat ``params/...``/``batch_stats/...``; ``load_flax_npz``);
    * a reference ``.pt``: a bare state dict or the trainer-state layout
      ``{"module": {"model": state_dict, ...}, ...}``, prefixes stripped;
      the port's own ``best.pt`` and ``last.pt`` are in that layout;
    * a checkpoint directory of the port (``trainer.ckpt_backend: orbax``);
    * a native JAX trainer checkpoint (a pickle around flax msgpack).

    A directory that orbax itself wrote raises
    (``utils.weights.read_state_dict``): export those weights as a flat
    npz."""
    sd = {k: v.detach().to(torch.float32) if v.is_floating_point() else v.detach()
          for k, v in read_state_dict(path).items()}
    if not sd:
        raise ValueError(f"no tensors found in torch checkpoint {path}")
    return sd


def mask_pad_region(avg: torch.Tensor, valid_hw) -> torch.Tensor:
    """``avg [N, K, H, W]`` with -1e4 outside the valid region, which is
    ``(h, w)`` for every image or an int ``[N, 2]`` tensor of per-image
    ``(h, w)`` on ``avg``'s device: shape-bucketing padding gets no
    detections."""
    if torch.is_tensor(valid_hw):
        vh, vw = valid_hw[:, 0].view(-1, 1, 1, 1), valid_hw[:, 1].view(-1, 1, 1, 1)
    else:
        vh, vw = valid_hw
    yy = torch.arange(avg.shape[2], device=avg.device)[:, None]
    xx = torch.arange(avg.shape[3], device=avg.device)[None, :]
    return torch.where((yy < vh) & (xx < vw), avg,
                       constant(-1e4, avg.dtype, avg.device))


def _pipeline_microbatch(total: int, n_segments: int) -> int:
    """Largest divisor of ``total`` that is <= ceil(total / n_segments):
    enough equal-size microbatches to fill all pipeline segments, so fill
    and drain overlap (one whole-batch microbatch would run the segments
    strictly one after another)."""
    target = max(1, -(-total // n_segments))
    for m in range(target, 0, -1):
        if total % m == 0:
            return m
    return 1


def _model_device(model: nn.Module, device) -> torch.device:
    """The device of ``model``'s parameters, which must be ``device``
    (resolved: the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device.type != dev.type or (dev.index is not None and model_device != dev):
        raise ValueError(f"model is on {model_device}, not on {dev}")
    return model_device


class InferenceKeypointsModel:
    limbs = COCO_LIMBS

    def __init__(
        self,
        model: nn.Module,
        det_thr: float = 0.05,
        tag_thr: float = 0.5,
        use_flip: bool = False,
        input_size: int = 512,
        max_num_people: int = 30,
        pad_multiple: int = 64,
        scales: tuple = (1.0,),
        pipeline_devices: int = 0,
        compact_inputs: bool = False,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
    ):
        """``model`` is the port's ``HigherHRNet`` in eval mode, already on
        ``device`` (default ``"cuda"``: raises without a card). ``dtype``
        bfloat16 runs the forward under ``torch.autocast`` (its outputs stay
        float32). ``pad_multiple`` > 64 buckets the 64-aligned input shapes
        into coarser classes by padding bottom/right; the decode masks the
        pad region. APPROXIMATE: padding alters activations within a
        receptive field of the pad edge; 64 = exact reference behavior.
        ``compact_inputs`` ships uint8 pixels to the device and normalizes
        there; bucket padding then uses ``PAD_PIXEL_U8``. ``pipeline_devices``
        N > 0 splits the forward into ``partition_for(N)``'s segments
        (``parallel/pipeline.py``): on ``cuda:0`` ... ``cuda:N-1`` for a
        model on the card (raising with fewer cards), on the CPU N times for
        a model there; the flip pass rides the same microbatch walk."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.device = _model_device(model, device)
        self._pipe = None
        if pipeline_devices:
            from ..parallel.pipeline import PipelinedModel, cuda_devices, partition_for

            partition = partition_for(pipeline_devices)
            devices = (cuda_devices(pipeline_devices) if self.device.type == "cuda"
                       else [self.device] * pipeline_devices)
            self._pipe = PipelinedModel(model, partition, devices, dtype=dtype)
        self.model = model
        self.dtype = dtype
        self.det_thr = det_thr
        self.tag_thr = tag_thr
        self.use_flip = use_flip
        self.input_size = input_size
        self.max_num_people = max_num_people
        self.pad_multiple = pad_multiple
        self.scales = tuple(scales)
        self.pipeline_devices = pipeline_devices
        self.compact_inputs = compact_inputs
        self.model_input_shape: tuple | None = None

    def _forward(self, x: torch.Tensor):
        if self.dtype == torch.float32:
            return self.model(x)
        with torch.autocast(self.device.type, dtype=self.dtype):
            return self.model(x)

    def _pipelined(self, x: torch.Tensor):
        """The pipeline's forward on ``x``, in microbatches that fill its
        segments (``_pipeline_microbatch``), its outputs on the model's
        device."""
        from ..parallel.pipeline import tree_to

        mb = _pipeline_microbatch(x.shape[0], len(self._pipe.segments))
        return tree_to(self._pipe(x, microbatch_size=mb), self.device)

    @torch.no_grad()
    @span("infer.forward")
    def forward_scale(self, x: torch.Tensor, hw: tuple):
        """One multi-scale pass on ``x`` (``[N, 3, H, W]`` on the model's
        device, uint8 or float): forward (+flip), aggregate stages, resize to
        the common decode size ``hw``. Returns (avg ``[N, K, h, w]``, tags
        list of ``[N, K, h, w]``, two with flip). The flip pass rides in the
        same forward as the plain one (eval BN: per-sample results), through
        the pipeline's walk when there is one."""
        x = prep_images(x)
        n = x.shape[0]
        forward = self._forward if self._pipe is None else self._pipelined
        stages_hms, tags = forward(torch.cat([x, x.flip(3)]) if self.use_flip else x)
        with span("infer.merge"):
            if self.use_flip:
                stages_hms = [merge_flip_heatmaps(h[:n], h[n:]) for h in stages_hms]
                tags_list = [tags[:n], flip_back(tags[n:])]
            else:
                tags_list = [tags]
            avg = resize_bilinear(average_stages(stages_hms), *hw)
            return avg, [resize_bilinear(t, *hw) for t in tags_list]

    @torch.no_grad()
    @span("infer.decode")
    def decode_masked(self, avg_sum, tags_list, hw, n_scales, valid_hw=None):
        """Average the scale sum, mask the bucket pad region and decode.
        ``valid_hw``: None (no pad region), ``(h, w)`` for every image, or
        an int ``[N, 2]`` tensor on the device, one valid size per image
        (the batched evaluator's, whose buckets hold several exact sizes).
        Returns (joints, scores, valid, avg ``[N, K, h, w]``), all on the
        device."""
        # a true division on every device: a Python-scalar divisor makes
        # PyTorch's CUDA kernel multiply by its reciprocal, an ulp off the
        # CPU's (and JAX's) quotient for 3 scales
        avg = avg_sum / constant(float(n_scales), avg_sum.dtype, avg_sum.device)
        if valid_hw is not None and (torch.is_tensor(valid_hw) or tuple(valid_hw) != tuple(hw)):
            avg = mask_pad_region(avg, valid_hw)
        joints, scores, valid = decode_batch(
            [avg], tags_list, input_hw=hw, max_num_people=self.max_num_people,
            det_thr=self.det_thr, tag_thr=self.tag_thr,
        )
        return joints, scores, valid, avg

    def _decode_aggregated(self, avg_sum, tags_list, hw, n_scales, valid_hw=None):
        """``decode_masked`` and the tags stacked for the result object:
        (joints, scores, valid, avg, tags ``[N, K, h, w, E]``)."""
        return (*self.decode_masked(avg_sum, tags_list, hw, n_scales, valid_hw),
                torch.stack(tags_list, dim=-1))

    def prepare_input(self, image: np.ndarray, current_scale: float = 1.0, min_scale: float = 1.0):
        """The host batch of one image at one scale: ``[1, H, W, 3]``, uint8
        with ``compact_inputs``, normalized float32 otherwise."""
        resized, center, scale = resize_align_multi_scale(
            image, self.input_size, current_scale, min_scale
        )
        if self.compact_inputs:
            if resized.dtype != np.uint8:
                # prep_images passes floats through UN-normalized — fail loud
                # instead of silently feeding raw pixels to the network
                raise ValueError(
                    f"compact_inputs requires uint8 images, got {resized.dtype} "
                    "(float inputs would skip normalization entirely)"
                )
            x = resized[None]
        else:
            x = normalize(resized)[None]
        if self.pad_multiple > 64:
            m = self.pad_multiple
            h, w = x.shape[1:3]
            ph, pw = -(-h // m) * m, -(-w // m) * m
            if self.compact_inputs:
                # pad with the uint8 pixel closest to normalized zero so the
                # bucket pad region matches the fp32 path's zero-padding
                padded = np.empty((1, ph, pw, 3), np.uint8)
                padded[:] = np.asarray(PAD_PIXEL_U8, np.uint8)
                padded[:, :h, :w] = x
                x = padded
            else:
                x = np.pad(x, ((0, 0), (0, ph - h), (0, pw - w), (0, 0)))
        return x, center, scale

    @span("infer.to_device")
    def to_device(self, xs: np.ndarray) -> torch.Tensor:
        """A host ``[N, H, W, 3]`` batch as ``[N, 3, H, W]`` on the model's
        device: uint8 stays uint8 (normalized on the device), floats as
        float32 (autocast casts them for a bfloat16 forward)."""
        return _to_device(xs, self.device)

    def __call__(self, raw_image: np.ndarray, annot=None, scales=None) -> InferenceKeypointsResult:
        """Single- or multi-scale (e.g. scales=(0.5, 1, 2)) TTA inference.
        Heatmaps are averaged across scales at the scale-1 decode size; tag
        maps come from scale 1 (the HigherHRNet multi-scale protocol).
        ``scales`` defaults to the constructor's."""
        scales = tuple(scales) if scales is not None else self.scales
        if 1.0 not in scales:
            # tags (and the decode geometry) always come from the scale-1 pass
            raise ValueError(f"scales must include 1.0, got {scales}")
        min_scale = min(scales)

        # decode size / inverse-affine params come from the scale-1 pass;
        # valid_hw is the pre-bucketing 64-aligned size (pad region masked)
        resized1, center, scale_wh = resize_align_multi_scale(
            raw_image, self.input_size, 1.0, min_scale
        )
        valid_hw = resized1.shape[:2]
        x1, _, _ = self.prepare_input(raw_image, 1.0, min_scale)
        h, w = x1.shape[1:3]
        self.model_input_shape = (h, w)

        avg_sum = None
        tags_list = None
        for s in sorted(scales, reverse=True):
            if s == 1.0:
                xs = x1
            else:
                xs, _, _ = self.prepare_input(raw_image, s, min_scale)
            avg, tags_s = self.forward_scale(self.to_device(xs), (h, w))
            avg_sum = avg if avg_sum is None else avg_sum + avg
            if s == 1.0:
                tags_list = tags_s
        joints, scores, valid, avg, tags = self._decode_aggregated(
            avg_sum, tags_list, (h, w), float(len(scales)), valid_hw=tuple(valid_hw)
        )
        vh, vw = valid_hw
        # to the host: the first image, cropped to the valid region, channel-last
        return InferenceKeypointsResult.from_decoded(
            raw_image=raw_image,
            annot=annot,
            model_input_image=(
                np.asarray(x1[0, :vh, :vw])  # uint8 compact input, displayable as-is
                if x1.dtype == np.uint8
                else inverse_normalize(np.asarray(x1[0, :vh, :vw], np.float32))
            ),
            avg_heatmaps=avg[0, :, :vh, :vw].permute(1, 2, 0).cpu().numpy(),
            tags_heatmaps=tags[0, :, :vh, :vw].permute(1, 2, 0, 3).cpu().numpy(),
            joints=joints[0].cpu().numpy(),
            obj_scores=scores[0].cpu().numpy(),
            valid=valid[0].cpu().numpy(),
            center=center,
            scale=scale_wh,
            det_thr=self.det_thr,
            tag_thr=self.tag_thr,
            limbs=self.limbs,
        )


def _to_device(xs: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host ``[N, H, W, 3]`` batch as ``[N, 3, H, W]`` on ``device``:
    uint8 stays uint8 (normalized on the device), floats as float32."""
    x = torch.from_numpy(np.ascontiguousarray(xs)).permute(0, 3, 1, 2)
    if x.dtype != torch.uint8:
        x = x.to(torch.float32)
    return x.contiguous().to(device)


class InferenceSPPEModel:
    """Single-person inference: forward + argmax decode, the SPPE analog of
    ``InferenceKeypointsModel`` (reference grouping.py:10-52,
    SPPEHeatmapParser). Drives ``HRNetSPPE``, ``SimpleBaseline`` and
    ``HourglassNet``: models returning a list of heatmap stages and no AE
    tags. One person an image; joints are decoded at the input size and
    mapped back to the raw image by the bottom-up path's inverse affine.
    No flip, no scales, no batching: the serving predictor and the batched
    evaluator refuse it, as the JAX package's do."""

    limbs = COCO_LIMBS

    def __init__(self, model: nn.Module, det_thr: float = 0.2, input_size: int = 512,
                 compact_inputs: bool = False, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda"):
        """``model`` in eval mode, already on ``device`` (default
        ``"cuda"``: raises without a card). ``dtype`` bfloat16 runs the
        forward under ``torch.autocast`` (heatmaps stay float32);
        ``compact_inputs`` ships uint8 pixels and normalizes on the
        device."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.device = _model_device(model, device)
        self.model = model
        self.dtype = dtype
        self.det_thr = det_thr
        self.tag_thr = 0.0  # unused; kept for the result and CLI interface
        self.input_size = input_size
        self.compact_inputs = compact_inputs
        self.model_input_shape: tuple | None = None

    @torch.no_grad()
    def forward_decode(self, x: torch.Tensor, hw: tuple):
        """Forward ``x`` (``[N, 3, H, W]`` on the model's device, uint8 or
        float), average the stages, resize to ``hw`` and decode: (avg
        ``[N, K, h, w]``, joints ``[N, 1, K, 3]``), on the device."""
        x = prep_images(x)
        if self.dtype == torch.float32:
            out = self.model(x)
        else:
            with torch.autocast(self.device.type, dtype=self.dtype):
                out = self.model(x)
        stages_hms = out[0] if isinstance(out, tuple) else out
        avg = resize_bilinear(average_stages(stages_hms), *hw)
        return avg, sppe_parse(avg)

    def prepare_input(self, image: np.ndarray):
        """The host batch of one image, 64-aligned at scale 1: ``[1, H, W,
        3]``, uint8 with ``compact_inputs``, normalized float32 otherwise;
        with the inverse affine's center and scale."""
        resized, center, scale = resize_align_multi_scale(image, self.input_size, 1.0, 1.0)
        if self.compact_inputs:
            if resized.dtype != np.uint8:
                raise ValueError(f"compact_inputs requires uint8 images, got {resized.dtype}")
            return resized[None], center, scale
        return normalize(resized)[None], center, scale

    def __call__(self, raw_image: np.ndarray, annot=None) -> InferenceKeypointsResult:
        x, center, scale_wh = self.prepare_input(raw_image)
        h, w = x.shape[1:3]
        self.model_input_shape = (h, w)
        avg, joints = self.forward_decode(_to_device(x, self.device), (h, w))
        joints = joints[0].cpu().numpy()  # [1, K, 3]
        # a zero tag column, so the layout is the AE path's ([..., 3:])
        joints = np.concatenate([joints, np.zeros_like(joints[..., :1])], axis=-1)
        avg = avg[0].permute(1, 2, 0).cpu().numpy()
        return InferenceKeypointsResult.from_decoded(
            raw_image=raw_image,
            annot=annot,
            model_input_image=(
                np.asarray(x[0]) if x.dtype == np.uint8
                else inverse_normalize(np.asarray(x[0], np.float32))
            ),
            avg_heatmaps=avg,
            tags_heatmaps=np.zeros((*avg.shape, 1), np.float32),
            joints=joints,
            obj_scores=joints[..., 2].mean(axis=-1),
            valid=np.ones((1,), bool),
            center=center,
            scale=scale_wh,
            det_thr=self.det_thr,
            tag_thr=self.tag_thr,
            limbs=self.limbs,
        )


class InferenceClassificationModel:
    def __init__(self, model: nn.Module, labels: list[str] | None = None, input_size: int = 224,
                 compact_inputs: bool = False, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda"):
        """``model`` is the port's ``ClassificationHRNet`` in eval mode,
        already on ``device`` (default ``"cuda"``: raises without a card).
        The host resizes the short side to ``input_size / 0.875`` and
        center-crops ``input_size``; ``compact_inputs`` ships the uint8 crop
        and normalizes on the device. ``dtype`` bfloat16 runs the forward
        under ``torch.autocast`` (logits and probabilities stay float32)."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        self.device = _model_device(model, device)
        self.model = model
        self.dtype = dtype
        self.labels = labels or [str(i) for i in range(1000)]
        self.transform = ClassificationTransform(out_size=input_size, normalize=not compact_inputs)

    def to_device(self, xs: np.ndarray) -> torch.Tensor:
        return _to_device(xs, self.device)

    @torch.no_grad()
    def probs(self, x: torch.Tensor) -> torch.Tensor:
        """Class probabilities ``[N, num_classes]`` float32 of a device batch
        ``[N, 3, H, W]`` (uint8 or normalized float), on the device."""
        x = prep_images(x)
        if self.dtype == torch.float32:
            logits = self.model(x)
        else:
            with torch.autocast(self.device.type, dtype=self.dtype):
                logits = self.model(x)
        return torch.softmax(logits, dim=-1)

    def __call__(self, raw_image: np.ndarray, target: int | None = None) -> ClassificationResult:
        x = self.transform.inference(raw_image)
        probs = self.probs(self.to_device(x[None]))[0].cpu().numpy()
        return ClassificationResult(image=x, probs=probs, labels=self.labels, target=target)

"""PyTorch + CUDA port of human_pose_tpu for NVIDIA Hopper (H100).

The JAX package ``human_pose_tpu`` is the reference this package is held
against; nothing here imports it or JAX. Module names mirror the reference's
so each counterpart is easy to find:

* ``models``  — HigherHRNet, ClassificationHRNet, the HRNet backbone (NCHW
  ``nn.Module``s, flax's train-mode BN)
* ``ops``     — the bottom-up associative-embedding decode; the sequential
  tag grouping and the refine argmax run as hand-written CUDA kernels
  (``csrc/``) on CUDA tensors and as their plain PyTorch versions on CPU
  tensors
* ``utils.weights`` — flax variable trees / npz files <-> torch state dicts
* ``inference`` — the keypoints inference model (64-aligned resize, flip
  and multi-scale TTA, the decode on the device), the classification one
  (center crop, softmax on the device) and their result objects;
  ``data``, ``metrics``, ``utils.image`` and ``loggers`` hold the host
  code it needs (NumPy; cv2 imported only inside the functions that use it)
* ``inference.batched_eval`` — shape-bucketed batched COCO evaluation
* ``configs`` — the yaml + ``--a.b.c=v`` keypoints and classification
  configs and their factories
* ``train`` — keypoints and classification training: losses, optimizers,
  schedulers, the train and val steps, ``KeypointsModule``,
  ``ClassificationModule``, the device prefetch and the engine (``Trainer``,
  callbacks, checkpoints); ``data`` holds the input pipelines (targets with
  a host C++ heatmap splat, augmentations, the COCO dataset's training side,
  ``collate``, the ImageNet ImageFolder dataset and its crops, the threaded
  loader)
* ``inference.serving`` — the dynamic-batching predictors, batcher and HTTP
  server; ``utils.export`` (``torch.export`` program, flat-weights npz),
  ``utils.model_info`` and ``utils.argv`` (the serve, bench_serve and
  export CLIs' flags)
* ``parallel`` — data-parallel training over ``torch.distributed``
  processes (torchrun's process group, the data mesh, per-group and
  process-group BatchNorm)
* ``bin`` — the keypoints and classification train, eval and inference
  CLIs, serve, bench_serve and export

Entry points that create tensors or models take ``device=`` and default to
``"cuda"``; they raise when no card is present instead of running on the CPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

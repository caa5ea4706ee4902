"""PyTorch + CUDA port of human_pose_tpu for NVIDIA Hopper (H100).

The JAX package ``human_pose_tpu`` is the reference this package is held
against; nothing here imports it or JAX. Module names mirror the reference's
so each counterpart is easy to find:

* ``models``  — HigherHRNet / HRNet backbone (NCHW ``nn.Module``s, eval BN)
* ``ops``     — the bottom-up associative-embedding decode; the sequential
  tag grouping and the refine argmax run as hand-written CUDA kernels
  (``csrc/``) on CUDA tensors and as their plain PyTorch versions on CPU
  tensors
* ``utils.weights`` — flax variable trees / npz files -> torch state dicts

Entry points that create tensors or models take ``device=`` and default to
``"cuda"``; they raise when no card is present instead of running on the CPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

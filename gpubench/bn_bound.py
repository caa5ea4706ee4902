"""The least device time of the BatchNorm backward pair
(``csrc/batch_norm_backward.cu``) over a training step, from its shapes:
PERF.md's row 7 bound, aware of the L2.

Per train-mode BatchNorm layer of ``n`` bf16 elements: the reduce reads x
and grad_y (4n bytes), the apply reads both again and writes grad_x (6n),
10n bytes in all, less the part of the apply's second read that the L2 can
serve (``min(4n, L2)``: 6n where x and grad_y fit in it together); over
the H100's 3.35 TB/s. The layers are the reference network's, at the
cell's batch and input size, each BatchNorm's input recorded on meta
tensors (``reference/nets.py`` for HigherHRNet and the classifier,
``reference/sppe.py`` for the top-down net), so the bound follows the
published shapes, not the program's kernels.
"""

from __future__ import annotations

import torch

from .counts import PEAK_BYTES_S
from .reference.nets import Net
from .reference.sppe import SPPENet

L2_BYTES = 50 * 2**20  # the H100's L2 (``L2_cache_size``)
ELEMENT_BYTES = 2  # bf16 x, grad_y and grad_x


def layer_bytes(n: int, l2_bytes: int = L2_BYTES) -> int:
    """Device-memory bytes of one layer's pair over ``n`` elements."""
    return 5 * ELEMENT_BYTES * n - min(2 * ELEMENT_BYTES * n, l2_bytes)


def bn_elements(arch: dict, input_hw: tuple, batch: int) -> list:
    """The elements of each train-mode BatchNorm's input, in the order the
    reference network applies them, for ``batch`` inputs of ``input_hw``."""
    net = SPPENet(arch) if arch["model"] == "HRNetSPPE" else Net(arch)
    sizes, bn = [], net.bn

    def recording(name, x, relu=False):
        sizes.append(x.numel())
        return bn(name, x, relu)

    net.bn = recording
    net(torch.empty((batch, 3, *input_hw), device="meta"))
    return sizes


def step_bound_s(arch: dict, input_hw: tuple, batch: int, l2_bytes: int = L2_BYTES) -> float:
    """Seconds the pair needs at least over one step's BatchNorm layers."""
    return sum(layer_bytes(n, l2_bytes) for n in bn_elements(arch, input_hw, batch)) / PEAK_BYTES_S

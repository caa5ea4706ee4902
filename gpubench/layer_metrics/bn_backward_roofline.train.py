"""The BatchNorm backward pair's share of its roofline (per cent): the
least time the H100 could take over the step's train-mode BatchNorm layers
at the cell's shapes (``gpubench/bn_bound.py``, the L2 of the run's card),
over the traced device time of the pair's kernels
(``hp_batch_norm_backward_reduce`` and ``_apply``) a step."""

import torch

from gpubench import bn_bound
from gpubench.harness import arch_of

KERNELS = "hp_batch_norm_backward"


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = ctx.trace.kernel_seconds(KERNELS) / ctx.params["trace_units"]
    if seconds <= 0:
        return None
    p = ctx.params
    hw = (p["height"], p["width"]) if "height" in p else (p["size"], p["size"])
    l2 = (torch.cuda.get_device_properties(ctx.device).L2_cache_size
          if ctx.device.type == "cuda" else bn_bound.L2_BYTES)
    return bn_bound.step_bound_s(arch_of(ctx.config), hw, p["batch"], l2) / seconds * 100

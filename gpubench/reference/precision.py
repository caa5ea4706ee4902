"""The reference's products in float32, or rounded to a lower precision:
the control that a cell's comparison has to fail.

``Exact`` applies convolutions, transposed convolutions and linear layers
as they are. ``Rounded(forward, backward)`` rounds each one's input and
weight to the format ``forward`` first and, in the backward, the gradient
that reaches its output to the format ``backward``; the float8 formats with
one scale a tensor (its largest magnitude onto the format's largest finite
value), as scaled float8 inference and training do (e4m3 forward, e5m2
backward). The products accumulate in float32. The backward passes the
gradient straight through the rounding and recomputes the product from the
rounded operands, so it keeps no more than the float32 reference does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FORMATS = {"float8_e4m3": (torch.float8_e4m3fn, 448.0),
           "float8_e5m2": (torch.float8_e5m2, 57344.0),
           "bfloat16": (torch.bfloat16, None)}


def rounding(name: str | None):
    """The function that rounds a tensor to format ``name`` and back (the
    identity for None)."""
    if name is None:
        return lambda t: t
    dtype, top = FORMATS[name]

    @torch.no_grad()
    def q(t):
        if top is None:
            return t.to(dtype).to(t.dtype)
        scale = t.abs().amax().clamp(min=1e-30) / top
        return (t / scale).to(dtype).to(t.dtype) * scale

    return q


class Exact:
    def conv2d(self, x, w, stride: int, pad: int):
        return F.conv2d(x, w, None, stride, pad)

    def conv_transpose2d(self, x, w, stride: int, pad: int):
        return F.conv_transpose2d(x, w, None, stride, pad)

    def linear(self, x, w):
        return F.linear(x, w)


class _RoundedOp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, q, qg, x, w, *args):
        ctx.fn, ctx.q, ctx.qg, ctx.args = fn, q, qg, args
        ctx.save_for_backward(x, w)
        return fn(q(x), q(w), *args)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        grad = ctx.qg(grad)
        need_x = ctx.needs_input_grad[3]
        with torch.enable_grad():
            qx = ctx.q(x).detach().requires_grad_(need_x)
            qw = ctx.q(w).detach().requires_grad_(True)
            y = ctx.fn(qx, qw, *ctx.args)
            grads = torch.autograd.grad(y, [qx, qw] if need_x else [qw], grad)
        gx, gw = grads if need_x else (None, grads[0])
        return (None, None, None, gx, gw) + (None,) * len(ctx.args)


class Rounded(Exact):
    def __init__(self, forward: str, backward: str | None = None):
        self.q, self.qg = rounding(forward), rounding(backward)

    def conv2d(self, x, w, stride: int, pad: int):
        return _RoundedOp.apply(super().conv2d, self.q, self.qg, x, w, stride, pad)

    def conv_transpose2d(self, x, w, stride: int, pad: int):
        return _RoundedOp.apply(super().conv_transpose2d, self.q, self.qg, x, w, stride, pad)

    def linear(self, x, w):
        return _RoundedOp.apply(super().linear, self.q, self.qg, x, w)

"""Idle device time (ms) a step while the host is inside the train step's
``train.backward`` stage (``.backward()``: the main thread waits there
while the autograd thread launches the backward's kernels)."""

from gpubench.layer_metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "train.backward")

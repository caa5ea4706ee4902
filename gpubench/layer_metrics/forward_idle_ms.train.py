"""Idle device time (ms) a step while the host is inside the train step's
``train.forward`` stage (the network's forward in train mode, under
autocast)."""

from gpubench.layer_metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "train.forward")

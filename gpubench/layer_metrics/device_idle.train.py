"""The device's idle share of the traced window (per cent): the window
less the union of every device operation's interval, over the window."""

from gpubench.layer_metrics._common import idle_share


def read(ctx):
    return idle_share(ctx)

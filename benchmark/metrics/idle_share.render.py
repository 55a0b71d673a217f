"""Share of the traced render window in which no operation ran on the
device: 1 - (union of the device's operation intervals) / window."""

from benchmark import trace


def read(ctx):
    return trace.idle_percent(ctx)

"""Device milliseconds a step: the profiled device time of every
operation but NCCL's over the traced window's steps (the lead rank's on
several cards)."""


def read(ctx):
    ms = sum(b - a for name, a, b in ctx.device_ops
             if "nccl" not in name.lower()) / 1e3
    return ms / ctx.steps if ms > 0 else None

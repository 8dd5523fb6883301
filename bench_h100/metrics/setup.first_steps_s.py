"""Seconds of the first steps that the comparison reads, through the
window's own call: the step's plans and kernels loaded, its first
capture, and the leaf norms read back."""


def read(ctx):
    return ctx.spans.get("setup.first_steps_s")

"""Seconds of the warm-up after the first steps: the rest of an epoch's
views (each bucket captured) and the steps that size the window."""


def read(ctx):
    return ctx.spans.get("setup.warmup_s")

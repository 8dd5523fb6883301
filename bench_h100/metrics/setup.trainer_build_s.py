"""Seconds in ``repro_torch.api.make_trainer``: plans, partitions and
view streams, the graph's copy to the card."""


def read(ctx):
    return ctx.spans.get("setup.trainer_build_s")

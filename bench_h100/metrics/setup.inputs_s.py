"""Seconds to make the cell's inputs from the seed: the graph (made on
the card by the traffic's generator, then copied to the host) and the
initial parameters."""


def read(ctx):
    return ctx.spans.get("setup.inputs_s")

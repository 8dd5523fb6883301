"""Share of the traced full-graph window in which no operation ran on
the card (the lead card's, on several)."""


def read(ctx):
    if ctx.device.type != "cuda" or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)

"""Full-graph training steps a second: every step of the window over the
window's host-clock time, the device drained (on several cards, the
slowest rank's window)."""


def read(ctx):
    return ctx.steps / ctx.window_s

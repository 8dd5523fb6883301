"""Seconds from the process's start to the program's side of the run:
the interpreter, torch, the program's modules and the card's context
(on several cards, until rank 0 starts)."""


def read(ctx):
    return ctx.spans.get("setup.start_s")

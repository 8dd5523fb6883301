"""Megabytes (1e6 bytes) that the lead rank sends to the other ranks in
one training step: the process's ``comm.*.bytes`` counters
(``repro_torch.utils.trace``) over the steps it ran. Each replay of the
captured step adds the bytes that the eager first step counted, so on
the card and on the CPU alike this is one step's payload."""


def read(ctx):
    try:
        from repro_torch.utils import trace
    except ImportError:
        return None
    steps = getattr(ctx.trainer, "steps_run", 0)
    sent = [v for k, v in trace.counts.items()
            if k.startswith("comm.") and k.endswith(".bytes")]
    return sum(sent) / steps / 1e6 if sent and steps else None

"""Host seconds of the program's plan builds (its ``plan.build`` span,
``repro_torch.utils.trace``: the Sum-stage plans, the partitions) in the
process; a full-graph cell builds them all in set-up (its one view
stages once, and the window replays)."""


def read(ctx):
    try:
        from repro_torch.utils import trace
    except ImportError:
        return None
    return trace.spans.get("plan.build", {}).get("seconds", 0.0)

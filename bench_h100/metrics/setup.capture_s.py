"""Host seconds of the program's warm-up steps and captures (its
``step.warm_up`` and ``step.capture`` spans, ``repro_torch.utils.trace``)
in the process: a full-graph cell's one capture, in its first step (0
where the step runs eagerly, as on the CPU)."""


def read(ctx):
    try:
        from repro_torch.utils import trace
    except ImportError:
        return None
    return sum(trace.spans.get(k, {}).get("seconds", 0.0)
               for k in ("step.warm_up", "step.capture"))

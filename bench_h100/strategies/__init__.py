"""One file a training strategy (``strategies/<strategy>.py``, found by
the traffic file's ``strategy``): ``step_graphs(g, mix, seed, steps)``,
the reference's own working-out of the graphs of the program's first
steps, and ``warmup_steps(mix, done)``. They import nothing of the
program."""

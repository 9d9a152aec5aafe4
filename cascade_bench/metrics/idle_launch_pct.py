"""idle_launch_pct (%), model step: the share of the traced slice's
window in which no device op ran while some worker was inside
``engine.forward``, launching the model's kernels (``spantrace.Joined``:
the program's spans joined to the profiler's trace on one clock). With
the copy class and ``idle_loop_pct`` it partitions ``idle_pct``."""
from cascade_bench import spantrace


def read(run):
    j = spantrace.joined(run)
    return None if j is None else j.idle_pct("launch")

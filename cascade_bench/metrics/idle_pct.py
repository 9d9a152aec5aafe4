"""idle_pct (%), device: the share of the traced slice's host-clock time
in which no device op (kernel, copy, set) ran, from the profiler's
trace."""


def read(run):
    if not run.trace or not run.slice_s or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.slice_s)

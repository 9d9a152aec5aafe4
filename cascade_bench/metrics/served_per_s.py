"""served_per_s (samples/s): forwarded samples whose results reached the
host inside the window, over the window's seconds (host clock)."""


def read(run):
    return sum(len(b.keys) for b in run.batches) / (run.t_end - run.t_start)

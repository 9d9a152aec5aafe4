"""host_ms_per_batch (ms), cascade loop: the window's host-clock time in
which no batch was in ``execute``, over the batches completed in it. Every
execute that overlaps the window counts for the part inside it."""


def read(run):
    if not run.batches:
        return None
    spans = sorted((max(b.t0, run.t_start), min(b.t1, run.t_end))
                   for b in run.executed if b.t0 < run.t_end)
    busy, cur0, cur1 = 0.0, None, None
    for t0, t1 in spans:
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    return (run.t_end - run.t_start - busy) * 1e3 / len(run.batches)

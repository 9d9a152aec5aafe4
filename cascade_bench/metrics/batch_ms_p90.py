"""batch_ms_p90 (ms): the 90th percentile of the host-clock time of every
batch's ``execute`` completed inside the window: the highest percentile
with ten batches beyond it in the smallest cell. Inclusive quantiles
(``statistics.quantiles(..., n=10, method="inclusive")``)."""
import statistics


def read(run):
    times = [(b.t1 - b.t0) * 1e3 for b in run.batches]
    if len(times) < 2:
        return None
    return statistics.quantiles(times, n=10, method="inclusive")[8]

"""queue_wait_ms_p90 (ms), engine: the 90th percentile of the host-clock
time requests waited in the server's queue (``queue.wait`` spans, from
``put`` to ``pop_batch``) over the requests both put and popped inside
the traced slice. Inclusive quantiles, as ``batch_ms_p90``."""
from cascade_bench import spantrace


def read(run):
    j = spantrace.joined(run)
    return None if j is None else spantrace.quantile90(j.queue_waits_ms())

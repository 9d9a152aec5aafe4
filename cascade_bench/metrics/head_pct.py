"""head_pct (%), model step: the device time of the ops launched inside
``model.head`` spans (final norm and the head's logits over every
position; each op joined to its launching call by ``correlation``), over
the traced slice's device busy time (``spantrace.Joined``)."""
from cascade_bench import spantrace


def read(run):
    j = spantrace.joined(run)
    if j is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * j.head_device_ns() * 1e-9 / run.trace["busy_s"]

"""launches_per_batch (launches), model step: the CUDA runtime and driver
calls of the traced slice that launched a kernel (joined to it by
``correlation``) made inside an ``engine.forward`` span on their own
thread, over the slice's forwards (``spantrace.Joined``)."""
from cascade_bench import spantrace


def read(run):
    j = spantrace.joined(run)
    return None if j is None else j.launches_per_batch()

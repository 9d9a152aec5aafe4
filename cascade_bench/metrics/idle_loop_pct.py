"""idle_loop_pct (%), cascade loop: the share of the traced slice's window
in which no device op ran and no worker was inside ``engine.forward``,
``engine.stack``, ``engine.copy_in`` or ``engine.copy_out``: the cascade
loop held the card back (``spantrace.Joined``; the breakdown's
``idle_by_span`` splits it by the transport span open then)."""
from cascade_bench import spantrace


def read(run):
    j = spantrace.joined(run)
    return None if j is None else j.idle_pct("loop")

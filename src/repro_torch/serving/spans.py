"""Spans of the serving path on the host clock, kept in memory.

The recorder is off by default. A span site then reads one module flag and
gets back a shared no-op context: no clock call, no allocation.
``enable()`` turns it on with a clock pair ``(time.perf_counter_ns(),
time.time_ns())``; ``drain()`` takes a second pair, turns it off and
returns what was recorded with both pairs, so that a reader can map a
trace written in Unix time (``torch.profiler``'s) onto ``perf_counter_ns``.

A ``Span`` holds its name, start and end in ``perf_counter_ns``, the OS
thread id (``threading.get_native_id()``), its own id and its parent's
(from a stack kept per thread; 0 for none), the id it belongs to (``key``:
an engine batch id, or a request's ``(device_id, sample)``). Two forms
record one:

* ``with span(name, key):`` around work on one thread;
* ``stamp()`` where work starts and ``record(name, t0, key)`` where it
  ends, for a wait that starts on another thread (a request's time in the
  queue, a batch's wait for a worker). ``stamp()`` is None while off, and
  ``record`` drops a span whose start was not stamped.

Records are appended under the interpreter lock. A span still open when
the recorder is drained is dropped.

Span sites: ``serving/transport.py`` (``transport.cluster``,
``transport.barrier``, ``transport.pool_wait``, ``transport.wait_result``),
``serving/engine.py`` (``engine.execute`` with ``engine.stack``,
``engine.copy_in``, ``engine.forward`` and ``engine.copy_out``),
``serving/queue.py`` (``queue.wait``) and ``serving/executables.py``
(``model.head``).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

ClockPair = Tuple[int, int]      # (perf_counter_ns, time_ns)

_on = False
_gen = 0                         # drains so far: a span opened before the
#                                  last drain is not recorded
_records: List["Span"] = []
_pair0: Optional[ClockPair] = None   # enable()'s
_ids = itertools.count(1)
_local = threading.local()
_threads: Dict[int, int] = {}    # native id -> threading.get_ident()


def clock_pair() -> ClockPair:
    return time.perf_counter_ns(), time.time_ns()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _threads[threading.get_native_id()] = threading.get_ident()
        return _local.stack


class Span:
    """One recorded span, and the context that records it."""

    __slots__ = ("name", "key", "start", "end", "tid", "id", "parent",
                 "_gen")

    def __init__(self, name: str, key=None):
        self.name, self.key = name, key
        self.start = self.end = 0
        self.id = next(_ids)
        self._gen = _gen

    def _open(self, stack: list) -> None:
        self.tid = threading.get_native_id()
        self.parent = stack[-1].id if stack else 0

    def __enter__(self) -> "Span":
        stack = _stack()
        self._open(stack)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, et, ev, tb) -> None:
        self.end = time.perf_counter_ns()
        _stack().pop()
        if self._gen == _gen and _on:
            _records.append(self)


class _Off:
    """The shared no-op context of a span site while the recorder is
    off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, et, ev, tb) -> None:
        return None


OFF = _Off()


def on() -> bool:
    return _on


def span(name: str, key=None):
    """A context that records a span around its body; ``OFF`` while the
    recorder is off."""
    if not _on:
        return OFF
    return Span(name, key)


def stamp() -> Optional[int]:
    """The start of a wait that ``record`` ends: now, or None while off."""
    if not _on:
        return None
    return time.perf_counter_ns()


def record(name: str, t0: Optional[int], key=None) -> None:
    """Record ``name`` from ``t0`` (a ``stamp()``) to now on this thread,
    under the span open here; nothing while off or where ``t0`` is None."""
    if not _on or t0 is None:
        return
    s = Span(name, key)
    s._open(_stack())
    s.start, s.end = t0, time.perf_counter_ns()
    _records.append(s)


@dataclasses.dataclass
class Drained:
    """What ``drain`` returns: the spans, the clock pairs taken by
    ``enable`` and ``drain``, and each recording thread's
    ``threading.get_ident()`` by its native id (the CUDA runtime's events
    in a ``torch.profiler`` trace carry the former's low 32 bits)."""
    spans: List[Span]
    pairs: Tuple[ClockPair, ClockPair]
    threads: Dict[int, int]


def enable(pair: Optional[ClockPair] = None) -> None:
    """Turn the recorder on, from the clock pair ``pair`` (taken now when
    None)."""
    global _on, _pair0
    _records.clear()
    _pair0 = pair or clock_pair()
    _on = True


def drain(pair: Optional[ClockPair] = None) -> Drained:
    """Turn the recorder off and hand over its spans with the clock pairs,
    ``pair`` (taken now when None) the second."""
    global _on, _records, _gen
    _on = False
    _gen += 1
    out, _records = _records, []
    return Drained(out, (_pair0, pair or clock_pair()), dict(_threads))

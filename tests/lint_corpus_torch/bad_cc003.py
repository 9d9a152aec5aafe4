"""CC003 corpus: the GUARDED_BY entry names a real lock — created in
``__init__``, held by ``put`` — but ``drain`` mutates the guarded deque
outside ``with self._lock``: declared-but-unlocked state."""
import threading


class LeakyBroker:
    GUARDED_BY = {
        "_q": "_lock: put() appends, drain() clears",
    }

    def __init__(self):
        self._lock = threading.Lock()
        self._q = []

    def put(self, item):
        with self._lock:
            self._q.append(item)

    def drain(self):
        out = list(self._q)
        self._q.clear()
        return out

"""CC002 corpus: a stale GUARDED_BY entry — the named attribute is not
multi-context-mutated, so the lock map has drifted from the code."""


class Meter:
    GUARDED_BY = {"window": "broker lock"}

    def __init__(self):
        self.count = 0

    def tick(self):
        self.count += 1

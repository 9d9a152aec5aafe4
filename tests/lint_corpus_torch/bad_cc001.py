"""CC001 corpus: an attribute mutated from two call contexts with no
GUARDED_BY entry naming the lock that will cover it."""


class Broker:
    def __init__(self):
        self.pending = []

    def put(self, item):
        self.pending.append(item)

    def drain(self):
        out = list(self.pending)
        self.pending.clear()
        return out

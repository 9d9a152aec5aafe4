"""HD004 corpus: host call into the simulator engine's per-trip methods
outside its loop — eager op soup instead of the captured graph."""


def close_window(engine, go):
    # BUG: go through the engine's run (or lane_stepper to inspect a trip)
    engine._boundary(go)

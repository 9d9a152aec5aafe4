"""The live cascade: device clients, server engine, closed loop."""

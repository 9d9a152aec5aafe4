"""Cascade decision, SLO accounting and the schedulers (paper Sec. IV)."""

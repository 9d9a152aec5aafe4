"""Live cascade serving: queue, dynamic batching, engine, clients, the
process-wide classify cache, and the sim-vs-serving replay harness."""
from repro_torch.serving.cascade import CascadeResult, run_cascade
from repro_torch.serving.client import DeviceClient
from repro_torch.serving.engine import ServedModel, ServerEngine
from repro_torch.serving.executables import cache_stats, clear_cache
from repro_torch.serving.queue import Request, RequestQueue
from repro_torch.serving.replay import (SERVING_TOL, StreamClient,
                                        replay_cascade, serving_vs_sim)

__all__ = ["run_cascade", "CascadeResult", "DeviceClient", "ServerEngine",
           "ServedModel", "Request", "RequestQueue", "cache_stats",
           "clear_cache", "SERVING_TOL", "StreamClient", "replay_cascade",
           "serving_vs_sim"]

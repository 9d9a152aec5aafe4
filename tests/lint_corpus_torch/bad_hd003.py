"""HD003 corpus: a CUDA graph made inside a factory with no memo — a
capture per call, not per structure."""
import torch


def make_graph():
    # BUG: memoize the factory (functools.lru_cache) or keep the graph
    return torch.cuda.CUDAGraph()

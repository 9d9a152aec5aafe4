"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the dispatch layer (``ops``) that picks one by the tensor's device."""

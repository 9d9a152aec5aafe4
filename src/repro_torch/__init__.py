"""MultiTASC++ on PyTorch and CUDA: the live cascade on an NVIDIA H100.

The PyTorch/CUDA counterpart of the ``repro`` JAX package, laid out
module for module like it (``configs``, ``core``, ``kernels``,
``models``, ``serving``, ``sim``). The JAX package is the reference the
tests hold this one to; this package imports nothing from it.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU. On a CUDA tensor every BvSB confidence and every causal
self-attention runs a hand-written CUDA kernel (``kernels/csrc``); on a
CPU tensor the same functions run their plain PyTorch versions.
"""

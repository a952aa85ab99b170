"""PyTorch/CUDA port of the PerLLM serving stack.

A twin of the JAX package ``repro``, laid out the same way module by module,
that imports neither JAX nor ``repro``. Its attention kernels are written by
hand in CUDA for Hopper (``kernels/csrc``); entry points run on the card
unless the caller passes ``device="cpu"``.
"""

"""One query token against a KV cache, bounded by a per-row position.

``ref`` is the plain PyTorch function, ``kernel`` the CUDA C++ kernel
for sm_90a, ``ops`` the dispatcher the model's decode step calls.
"""

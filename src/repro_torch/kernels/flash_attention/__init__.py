"""Causal / windowed / softcapped GQA attention over a whole sequence.

``ref`` is the plain PyTorch function, ``kernel`` the CUDA C++ kernel
for sm_90a, ``ops`` the dispatcher the model's prefill calls.
"""

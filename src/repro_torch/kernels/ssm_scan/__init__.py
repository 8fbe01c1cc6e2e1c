"""One chunk of the Mamba-1 selective scan, and the chunked scan over a
whole sequence.

``ref`` holds the plain PyTorch functions (the sequential oracle, one
decode step, one chunk), ``kernel`` the CUDA C++ chunk kernel for
sm_90a, ``ops`` the dispatcher the Mamba layer's prefill calls.
"""

"""Hand-written CUDA kernels of the port, each beside its plain version.

Every kernel package keeps the ``ref.py`` / ``ops.py`` / ``kernel.py``
split: ``ref`` is the plain PyTorch function, ``kernel`` builds and
launches the CUDA source under ``csrc/``, and ``ops`` dispatches on the
resolved implementation.
"""

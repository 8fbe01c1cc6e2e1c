"""PyTorch port of the MIDAS reproduction, for one NVIDIA H100.

The package mirrors ``repro`` module for module (``core/``,
``kernels/``), so each module's counterpart sits at the same path.  It
imports ``torch`` and ``numpy`` only.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; without a card they
raise rather than fall back to the CPU.

The simulator's main path (``core.simulate`` with the ``midas`` policy,
the cooperative cache and the hysteresis controller) routes every wave
through the hand-written CUDA kernel in
``kernels/midas_route/csrc/route_select.cu``.  The serving path
(``launch.serve.serve``: the MIDAS router in front of prefill and
greedy decode of the dense attention models in ``models/``) runs its
attention through ``kernels/flash_attention`` and
``kernels/decode_attention``.
"""

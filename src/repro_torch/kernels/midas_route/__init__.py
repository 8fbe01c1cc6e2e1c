"""MIDAS routing: the simulator's ``route_select`` and the MoE layer's
``midas_dispatch``, each as CUDA kernels beside their plain versions.

``ref`` is the plain PyTorch functions, ``kernel`` the CUDA C++ kernels
for sm_90a, ``ops`` the dispatchers the routing policies and the MoE
layer call.
"""

"""MIDAS wave routing: the ``route_select`` kernel and its plain version.

``ref`` is the plain PyTorch function, ``kernel`` the CUDA C++ kernel
for sm_90a, ``ops`` the dispatcher the routing policies call.
"""

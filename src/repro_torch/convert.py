"""Carry state and workload grids from the JAX reference into the port.

The parity tests start both engines from the same state and feed both
the same realized grids.  The reference's arrays arrive here as numpy
(the caller runs ``jax.device_get``); this module never imports JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.sim import SimConfig, SimState, init_state
from repro_torch.core.workloads import Workload
from repro_torch.kernels.common import resolve_device


def _like(template: Any, value: Any, path: str) -> Any:
    """``value`` (numpy leaves, nested tuples/NamedTuples) converted to
    the structure, dtypes and device of ``template``."""
    if torch.is_tensor(template):
        arr = np.array(value)
        if arr.shape != tuple(template.shape):
            raise ValueError(
                f"{path}: shape {arr.shape}, expected "
                f"{tuple(template.shape)}"
            )
        if arr.dtype == np.uint32:  # threefry keys
            arr = arr.astype(np.int64)
        return torch.as_tensor(arr).to(
            dtype=template.dtype, device=template.device
        ).clone()
    if isinstance(template, tuple):
        if len(value) != len(template):
            raise ValueError(
                f"{path}: {len(value)} fields, expected {len(template)}"
            )
        fields = getattr(template, "_fields", None)
        items = [
            _like(t, v, f"{path}.{fields[i] if fields else i}")
            for i, (t, v) in enumerate(zip(template, value))
        ]
        return type(template)(*items) if fields else tuple(items)
    raise TypeError(f"{path}: unsupported template leaf {template!r}")


def state_from_numpy(tree: Any, cfg: SimConfig, device=None) -> SimState:
    """The reference's ``SimState`` (numpy leaves) as the port's
    ``SimState`` on ``device``, field for field."""
    template = init_state(cfg, device=resolve_device(device))
    return _like(template, tree, "SimState")


def workload_from_numpy(
    keys, mask, is_write, N: int, device=None, name: str = ""
) -> Workload:
    """A realized (T, R) grid as the port's ``Workload`` on ``device``."""
    dev = resolve_device(device)
    return Workload(
        keys=torch.as_tensor(np.array(keys, np.int32), device=dev),
        mask=torch.as_tensor(np.array(mask, bool), device=dev),
        is_write=torch.as_tensor(np.array(is_write, bool), device=dev),
        name=name,
        N=int(N),
    )

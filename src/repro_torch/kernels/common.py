"""Device resolution and kernel dispatch helpers.

The port runs on the CUDA device unless the caller asks for the CPU.
There is no silent fallback: asking for the card on a machine without
one raises, and so does asking for the CUDA kernel on CPU tensors.
There is no environment-variable override either.
"""

from __future__ import annotations

import torch

# choices for SimConfig.route_impl: "auto" resolves per device ("cuda"
# for tensors on the card, "ref" on the CPU); "ref" pins the plain
# PyTorch version; "cuda" forces the hand-written kernel
ROUTE_IMPLS = ("auto", "ref", "cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; raise when it is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run "
            "the port on the CPU"
        )
    return dev


def resolve_route_impl(name: str, device: torch.device) -> str:
    """Resolve a ``SimConfig.route_impl`` choice to "ref" or "cuda"."""
    if name not in ROUTE_IMPLS:
        raise ValueError(
            f"unknown route_impl {name!r}; available: "
            f"{', '.join(ROUTE_IMPLS)}"
        )
    device = torch.device(device)
    if name == "auto":
        return "cuda" if device.type == "cuda" else "ref"
    if name == "cuda" and device.type != "cuda":
        raise ValueError(
            f"route_impl='cuda' needs tensors on a CUDA device, "
            f"got {device}"
        )
    return name

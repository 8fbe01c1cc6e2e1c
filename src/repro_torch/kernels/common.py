"""Device resolution and kernel dispatch helpers.

The port runs on the CUDA device unless the caller asks for the CPU.
There is no silent fallback: asking for the card on a machine without
one raises, and so does asking for the CUDA kernel on CPU tensors.
There is no environment-variable override either.
"""

from __future__ import annotations

import torch

# choices for every kernel implementation option (SimConfig.route_impl,
# the model's impl): "auto" resolves per device ("cuda" for tensors
# on the card, "ref" on the CPU); "ref" pins the plain PyTorch version;
# "cuda" forces the hand-written kernel
IMPLS = ("auto", "ref", "cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; raise when it is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run "
            "the port on the CPU"
        )
    return dev


def resolve_impl(name: str, device, option: str = "impl") -> str:
    """Resolve an ``IMPLS`` choice to "ref" or "cuda" for tensors on
    ``device``; ``option`` names the setting in error messages."""
    if name not in IMPLS:
        raise ValueError(
            f"unknown {option} {name!r}; available: {', '.join(IMPLS)}"
        )
    device = torch.device(device)
    if name == "auto":
        return "cuda" if device.type == "cuda" else "ref"
    if name == "cuda" and device.type != "cuda":
        raise ValueError(
            f"{option}='cuda' needs tensors on a CUDA device, got {device}"
        )
    return name


def refuse_grad(name: str, why: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when autograd would need the
    gradient of kernel ``name``, which it does not have (``why`` says
    where it is queued or what to call instead): gradients are enabled
    and one of ``tensors`` requires one.  A kernel wrapper calls this
    before its device checks, so that a result never leaves it without
    a gradient path."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel: {why}"
        )


def check_tensor(name, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``: what a kernel wrapper checks before it passes a
    pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

"""Public wrapper for whole-sequence attention: dispatch on impl."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import resolve_impl
from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    impl: str = "auto",
) -> torch.Tensor:
    """q: (B, S, H, D); k, v: (B, S, KV, D) -> (B, S, H, D).  ``impl``
    is an ``IMPLS`` choice: "auto" launches the CUDA kernel for tensors
    on the card and runs the plain version on the CPU."""
    if resolve_impl(impl, q.device) == "ref":
        return ref.mha(q, k, v, causal=causal, window=window,
                       softcap=softcap)
    # the kernel reads contiguous tensors (a no-op where they already are)
    return kernel.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
        window=window, softcap=softcap,
    )

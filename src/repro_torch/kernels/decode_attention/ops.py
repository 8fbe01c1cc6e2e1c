"""Public wrapper for single-token KV-cache attention: dispatch on
impl."""

from __future__ import annotations

import torch

from repro_torch.kernels.common import resolve_impl
from repro_torch.kernels.decode_attention import kernel, ref


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    pos: torch.Tensor,
    *,
    window: int = 0,
    softcap: float = 0.0,
    impl: str = "auto",
) -> torch.Tensor:
    """q: (B, H, D); caches: (B, S, KV, D); pos: (B,) -> (B, H, D).
    ``impl`` is an ``IMPLS`` choice: "auto" launches the CUDA kernel for
    tensors on the card and runs the plain version on the CPU."""
    if resolve_impl(impl, q.device) == "ref":
        return ref.decode_attention(q, k_cache, v_cache, pos,
                                    window=window, softcap=softcap)
    return kernel.decode_attention(
        q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
        pos.to(torch.int32).contiguous(), window=window, softcap=softcap,
    )

"""Chunked selective scan: the counterpart of
``repro/kernels/ssm_scan/ops.py``.

The sequence is cut into chunks of ``chunk`` steps; one chunk is
solved by ``chunk_scan`` (the CUDA kernel on the card, the plain
log-step scan elsewhere) and the (Bt, DI, ST) state is carried from
chunk to chunk, one kernel launch per chunk, as the reference's
``body_pallas`` does under ``lax.scan``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import resolve_impl
from repro_torch.kernels.ssm_scan import kernel, ref


def selective_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    *,
    chunk: int = 128,
    impl: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`ref.selective_scan`.  ``impl`` is an
    ``IMPLS`` choice: "auto" launches the CUDA kernel for tensors on the
    card and runs the plain version on the CPU; "ref" runs the
    sequential oracle when the sequence fits one chunk, as the
    reference does.  Math is float32; S is zero-padded to a multiple of
    ``chunk`` (padded steps have dt = 0, so they leave h unchanged)."""
    impl = resolve_impl(impl, x.device)
    Bt, S, DI = x.shape
    ST = A.shape[1]
    if impl == "ref" and S <= chunk:
        return ref.selective_scan(x, dt, A, B, C, D, h0)
    if h0 is None:
        h0 = torch.zeros((Bt, DI, ST), dtype=torch.float32, device=x.device)
    n = -(-S // chunk)
    pad = n * chunk - S

    def padded(a):  # (Bt, S, k) -> float32 (Bt, n * chunk, k)
        return F.pad(a.float(), (0, 0, 0, pad))

    xf, dtf, Bf, Cf = padded(x), padded(dt), padded(B), padded(C)
    Af = A.float().contiguous()
    h = h0.float().contiguous()
    step = ref.chunk_scan if impl == "ref" else kernel.chunk_scan
    ys = []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        y, h = step(h, xf[:, sl].contiguous(), dtf[:, sl].contiguous(), Af,
                    Bf[:, sl].contiguous(), Cf[:, sl].contiguous())
        ys.append(y)
    y = torch.cat(ys, 1)[:, :S] + D.float() * x.float()
    return y.to(x.dtype), h


selective_step = ref.selective_step

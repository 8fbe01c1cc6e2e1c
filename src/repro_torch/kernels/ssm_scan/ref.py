"""Plain PyTorch Mamba-1 selective scan: the counterparts of
``repro/kernels/ssm_scan/ref.py`` and of ``ops._chunk_scan``.

    h_t = exp(Δ_t ⊙ A) · h_{t-1} + Δ_t ⊙ B_t · x_t
    y_t = C_t · h_t + D ⊙ x_t

:func:`selective_scan` is the sequential oracle (a Python loop over
time steps: slow, obviously correct); :func:`chunk_scan` solves one
chunk with a log-step scan over its time axis and is what the chunked
scan runs where the CUDA kernel does not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def selective_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: (Bt, S, DI); A: (DI, ST); B, C: (Bt, S, ST); D: (DI,).
    Returns (y: (Bt, S, DI) in x's dtype, h_final: (Bt, DI, ST)
    float32)."""
    Bt, S, DI = x.shape
    ST = A.shape[1]
    xf, dtf = x.float(), dt.float()
    Af, Bf, Cf, Df = A.float(), B.float(), C.float(), D.float()
    if h0 is None:
        h = torch.zeros((Bt, DI, ST), dtype=torch.float32, device=x.device)
    else:
        h = h0.float()
    ys = []
    for t in range(S):
        x_t, dt_t = xf[:, t], dtf[:, t]  # (Bt, DI)
        da = torch.exp(dt_t[..., None] * Af[None])  # (Bt, DI, ST)
        db = dt_t[..., None] * Bf[:, t, None, :]
        h = da * h + db * x_t[..., None]
        ys.append(torch.einsum("bds,bs->bd", h, Cf[:, t]) + Df * x_t)
    y = torch.stack(ys, 1) if ys else xf.new_zeros((Bt, 0, DI))
    return y.to(x.dtype), h


def selective_step(x_t, dt_t, A, B_t, C_t, D, h):
    """One decode step.  x_t, dt_t: (Bt, DI); B_t, C_t: (Bt, ST);
    h: (Bt, DI, ST) float32.  Returns (y_t: (Bt, DI) in x_t's dtype,
    h_new)."""
    dtf, xf = dt_t.float(), x_t.float()
    da = torch.exp(dtf[..., None] * A.float()[None])
    db = dtf[..., None] * B_t.float()[:, None, :]
    h = da * h + db * xf[..., None]
    y = torch.einsum("bds,bs->bd", h, C_t.float()) + D.float() * xf
    return y.to(x_t.dtype), h


def chunk_scan(h0, x, dt, A, B, C) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the scan, the CUDA kernel's contract: h0 (Bt, DI,
    ST) carry; x, dt: (Bt, Q, DI); A: (DI, ST); B, C: (Bt, Q, ST).
    Returns (y: (Bt, Q, DI) float32 WITHOUT the D·x skip, h_out: (Bt,
    DI, ST) float32).

    Each step is the affine map h -> a_t h + b_t (a_t = exp(dt_t A),
    b_t = dt_t B_t x_t).  A Hillis-Steele scan composes them in
    ceil(log2 Q) steps of whole-tensor ops, so the chunk costs a few
    dozen launches on the card, not several per time step."""
    Q = x.shape[1]
    dtf = dt.float()[..., None]  # (Bt, Q, DI, 1)
    a = torch.exp(dtf * A.float())  # (Bt, Q, DI, ST)
    b = dtf * B.float()[:, :, None, :] * x.float()[..., None]
    k = 1
    while k < Q:
        # step t takes in step t - k: (a, b)_t <- (a_t a_{t-k},
        # a_t b_{t-k} + b_t); steps before k are already complete
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], 1)
        a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], 1)
        k *= 2
    h_all = a * h0.float()[:, None] + b  # (Bt, Q, DI, ST)
    y = torch.einsum("bqds,bqs->bqd", h_all, C.float())
    return y, h_all[:, -1]

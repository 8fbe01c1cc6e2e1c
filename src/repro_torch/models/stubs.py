"""Modality frontends: the counterparts of ``repro/models/stubs.py``.

The audio (MusicGen) and vision (LLaVA-NeXT) archs specify the
transformer backbone only; the caller provides precomputed frame or
patch embeddings.  These stubs add the minimal glue: sinusoidal
positions for audio frames, and a learned projector for vision patches,
which are prepended to the text token embeddings.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ArchConfig
from repro_torch.models.layers import _param, einsum


def sinusoidal_positions(S: int, d: int, device=None) -> torch.Tensor:
    """(S, d) float32 positions: sin of the angles on the even columns,
    cos of the first ``d - d // 2`` angles on the odd ones, as the
    reference slices them.  At an odd ``d`` that slice has one column
    more than the odd columns, and the reference's scatter refuses it
    with a ``ValueError``; so does this one."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None]
    ang = pos / (10000.0 ** (dim / d))
    out = torch.zeros((S, d), dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(ang)
    cos = torch.cos(ang[:, : (d - d // 2)])
    if cos.shape[1] != d // 2:
        raise ValueError(
            f"Incompatible shapes for broadcasting: {tuple(cos.shape)} "
            f"and requested shape {(S, d // 2)}"
        )
    out[:, 1::2] = cos
    return out


class Frontend(nn.Module):
    """The vision projector ``proj`` (d_model, d_model), the
    reference's ``params["frontend"]["proj"]``; the audio frontend has
    no parameter."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.proj = _param((cfg.d_model, cfg.d_model), device, dtype)


def frontend_init(cfg: ArchConfig, *, device=None,
                  dtype=torch.float32) -> Frontend | None:
    """The frontend's parameters (uninitialised), or None where the
    frontend has none."""
    if cfg.frontend == "vlm_patches":
        return Frontend(cfg, device=device, dtype=dtype)
    return None


def audio_frontend(cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S, d_model) precomputed EnCodec frame embeddings, plus
    their sinusoidal positions."""
    S, d = frames.shape[1], frames.shape[2]
    pos = sinusoidal_positions(S, d, frames.device).to(frames.dtype)
    return frames + pos[None]


def vlm_frontend(p: Frontend, cfg: ArchConfig, patches: torch.Tensor,
                 token_embeds: torch.Tensor) -> torch.Tensor:
    """patches: (B, P, d_model) precomputed patch embeddings, projected
    and prepended to the text token embeddings."""
    proj = einsum("bpd,de->bpe", patches, p.proj)
    return torch.cat([proj.to(token_embeds.dtype), token_embeds], dim=1)

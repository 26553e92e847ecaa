"""Positional encodings (port of ``focused_attention_vit_tpu/ops/posenc.py``):
the fixed 1-D sinusoidal table and the SPPP models' centroid encoding.

With centroids, the first half of the embedding is ``sin(x * freq)`` and the
second half ``cos(y * freq)``, concatenated (not interleaved: the reference's
comments say interleave, its arithmetic concatenates, and JAX keeps the
arithmetic); a (0.5, 0.5) class-token centroid is prepended when there are
fewer centroids than tokens.
"""

from __future__ import annotations

import math

import torch


def sinusoidal_positional_encoding(seq_len: int, embed_dim: int,
                                   dtype=torch.float32,
                                   device=None) -> torch.Tensor:
    """Standard 1-D sinusoidal table ``[S, D]``: even dims sin, odd cos."""
    position = torch.arange(seq_len, dtype=torch.float32,
                            device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, embed_dim, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / embed_dim))
    pe = torch.zeros(seq_len, embed_dim, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe.to(dtype)


def centroid_positional_encoding(centroids: torch.Tensor, embed_dim: int,
                                 seq_len: int,
                                 dtype=torch.float32) -> torch.Tensor:
    """``[B, S, D]`` encoding from ``[B, R, 2]`` centroids (channel 0 x,
    channel 1 y), computed in f32 and cast to ``dtype``."""
    b, r, _ = centroids.shape
    if r < seq_len:
        cls = torch.full((b, seq_len - r, 2), 0.5, dtype=centroids.dtype,
                         device=centroids.device)
        centroids = torch.cat([cls, centroids], dim=1)
    half = embed_dim // 2
    freq = torch.exp(
        torch.arange(half, dtype=torch.float32, device=centroids.device)
        * (-math.log(10000.0) / half))
    x_pos = centroids[:, :, 0:1].float()
    y_pos = centroids[:, :, 1:2].float()
    return torch.cat([torch.sin(x_pos * freq), torch.cos(y_pos * freq)],
                     dim=-1).to(dtype)

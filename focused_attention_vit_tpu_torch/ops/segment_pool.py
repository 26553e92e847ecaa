"""Superpixel patch pooling as fixed-shape ops (port of
``focused_attention_vit_tpu/ops/segment_pool.py``).

Each patch is assigned the superpixel that covers most of its pixels, and
the patch embeddings are pooled per superpixel into R = ``num_segments``
tokens indexed by segment id: a segment that owns no patch gives a zero
token, and an empty segment's centroid is (0.5, 0.5), as in the reference
(models/sppp.py:165-189, :444-447). Indexing by id keeps each pooled token
aligned with its centroid.

The products run in f32 with autocast off and the results are cast back to
the embeddings' dtype, as JAX's ``preferred_element_type=f32`` einsums do;
the member counts are taken in the embeddings' dtype, as in JAX.
"""

from __future__ import annotations

import torch

POOLING_TYPES = ("mean", "max", "attention")


def dominant_superpixel_per_patch(segmap: torch.Tensor, patch_size: int,
                                  num_segments: int) -> torch.Tensor:
    """Per-patch dominant segment id: ``[..., H, W]`` int labels to
    ``[..., N]`` int32 ids, N = (H/p)(W/p) in row-major patch order. The
    argmax of the per-patch counts, so a tie goes to the smallest id (the
    reference's ``torch.unique(...).argmax``)."""
    *lead, h, w = segmap.shape
    p = patch_size
    gh, gw = h // p, w // p
    tiles = segmap.reshape(-1, gh, p, gw, p).permute(0, 1, 3, 2, 4)
    tiles = tiles.reshape(-1, p * p).long()
    counts = torch.zeros(tiles.shape[0], num_segments, dtype=torch.int32,
                         device=segmap.device)
    counts.scatter_add_(1, tiles, torch.ones_like(tiles, dtype=torch.int32))
    return counts.argmax(-1).to(torch.int32).reshape(*lead, gh * gw)


def _onehot(ids: torch.Tensor, num_segments: int, dtype) -> torch.Tensor:
    classes = torch.arange(num_segments, device=ids.device)
    return (ids[..., None] == classes).to(dtype)


def segment_pool(patch_embeddings: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, pooling_type: str = "mean"
                 ) -> torch.Tensor:
    """Pool ``[B, N, D]`` patch embeddings into ``[B, R, D]`` segment
    tokens by ``[B, N]`` segment ids: ``mean``, ``max`` (JAX's
    ``segment_max`` on f32) or ``attention`` (a per-segment softmax over
    each patch's embedding sum). Segments that own no patch give zeros."""
    if pooling_type not in POOLING_TYPES:
        raise ValueError(f"Unsupported pooling type: {pooling_type}")
    emb = patch_embeddings
    with torch.autocast(emb.device.type, enabled=False):
        b, n, d = emb.shape
        ids = segment_ids.long()
        onehot = _onehot(ids, num_segments, emb.dtype)  # [B, N, R]
        member = (onehot.sum(1) > 0)[..., None]  # [B, R, 1]
        if pooling_type == "mean":
            counts = onehot.sum(1)
            sums = torch.bmm(onehot.transpose(1, 2).float(), emb.float())
            pooled = sums / counts.clamp_min(1.0)[..., None]
        elif pooling_type == "max":
            pooled = torch.full((b, num_segments, d), -torch.inf,
                                device=emb.device).scatter_reduce(
                1, ids[..., None].expand(b, n, d), emb.float(), "amax")
        else:
            logits = emb.sum(-1).float()  # [B, N], summed in emb's dtype
            seg_max = torch.full((b, num_segments), -torch.inf,
                                 device=emb.device).scatter_reduce(
                1, ids, logits, "amax")
            e = torch.exp(logits - seg_max.gather(1, ids))
            denom = torch.bmm(e[:, None, :], onehot.float())[:, 0]
            weights = e / denom.clamp_min(1e-30).gather(1, ids)
            pooled = torch.bmm((onehot.float() * weights[..., None])
                               .transpose(1, 2), emb.float())
        return torch.where(member, pooled, 0.0).to(emb.dtype)


def superpixel_centroids(segmaps: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """Normalised (x, y) centroid per segment id: ``[B, H, W]`` labels to
    ``[B, R, 2]`` f32, x = column / W in channel 0 and y = row / H in
    channel 1; an empty segment gets (0.5, 0.5) (reference
    ``_calculate_superpixel_centroids``, models/sppp.py:413-449)."""
    b, h, w = segmaps.shape
    dev = segmaps.device
    with torch.autocast(dev.type, enabled=False):
        y = (torch.arange(h, dtype=torch.float32, device=dev) / h)[:, None]
        x = (torch.arange(w, dtype=torch.float32, device=dev) / w)[None, :]
        coords = torch.stack([x.expand(h, w).reshape(-1),
                              y.expand(h, w).reshape(-1)], dim=-1)
        onehot = _onehot(segmaps.reshape(b, h * w).long(), num_segments,
                         torch.float32)  # [B, H*W, R]
        counts = onehot.sum(1)[..., None]  # [B, R, 1]
        sums = torch.matmul(onehot.transpose(1, 2), coords)  # [B, R, 2]
        centroids = sums / counts.clamp_min(1.0)
        return torch.where(counts > 0, centroids, 0.5)

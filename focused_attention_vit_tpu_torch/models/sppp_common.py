"""The SPPP token pipeline and the stem and head the three SPPP models share
(port of ``focused_attention_vit_tpu/models/sppp_common.py``).

SLIC superpixels, then the dominant superpixel of each patch, the patch
embeddings pooled per superpixel, the cls token, the superpixel centroids
and the centroid positional encoding: R + 1 tokens, R = ``num_superpixels``
(reference models/sppp.py:451-497). The models have no learned position
embedding.
"""

from __future__ import annotations

import torch
from torch import nn

from focused_attention_vit_tpu_torch.models.layers import (
    DropoutRNG,
    PatchEmbedding,
    init_weights,
    inverted_dropout,
)
from focused_attention_vit_tpu_torch.ops.posenc import (
    centroid_positional_encoding,
)
from focused_attention_vit_tpu_torch.ops.segment_pool import (
    dominant_superpixel_per_patch,
    segment_pool,
    superpixel_centroids,
)
from focused_attention_vit_tpu_torch.ops.slic import slic_segment


def sppp_tokens(images: torch.Tensor, patch_embeddings: torch.Tensor,
                cls_token: torch.Tensor, *, patch_size: int,
                num_superpixels: int, compactness: float, pooling_type: str,
                slic_iters: int = 10, slic_sigma: float = 1.0,
                slic_connectivity: "bool | str" = "auto") -> torch.Tensor:
    """``[B, R+1, D]`` tokens, the centroid encoding added, from ``[B, H,
    W, C]`` images (SLIC reads them in f32), their ``[B, N, D]`` patch
    embeddings and the ``[1, 1, D]`` cls token. Pooled tokens are in
    segment-id order; the tokens take the embeddings' dtype."""
    b, _, d = patch_embeddings.shape
    segmaps = slic_segment(images, num_segments=num_superpixels,
                           compactness=compactness, sigma=slic_sigma,
                           n_iter=slic_iters,
                           enforce_connectivity=slic_connectivity)
    seg_ids = dominant_superpixel_per_patch(segmaps, patch_size,
                                            num_superpixels)
    pooled = segment_pool(patch_embeddings, seg_ids, num_superpixels,
                          pooling_type)
    cls = cls_token.expand(b, 1, d).to(pooled.dtype)
    tokens = torch.cat([cls, pooled], dim=1)
    centroids = superpixel_centroids(segmaps, num_superpixels)
    return tokens + centroid_positional_encoding(
        centroids, d, tokens.shape[1], dtype=tokens.dtype)


class SPPPBase(nn.Module):
    """Patch embedding and cls token, the SPPP tokens, ``depth`` blocks
    built by ``make_block()``, final LayerNorm and a linear head on the cls
    token: no ``pos_embed``. NHWC images in, ``[B, num_classes]`` logits
    out; weights from ``generator`` (a fresh one seeded 0 when None), on
    ``device``. The model computes in its parameters' dtype: the patch
    embedding takes the images in that dtype, while SLIC reads them in f32,
    so a bf16 model may be given f32 images. In training mode
    ``embed_dropout`` applies after the encoding is added, drawn from the
    :class:`~.layers.DropoutRNG` passed to :meth:`forward`."""

    def __init__(self, make_block, *, img_size: int, patch_size: int,
                 in_channels: int, num_classes: int, embed_dim: int,
                 depth: int, num_heads: int, embed_dropout: float,
                 num_superpixels: int, compactness: float, pooling_type: str,
                 slic_iters: int, slic_connectivity, device,
                 generator: torch.Generator | None):
        super().__init__()
        if img_size % patch_size:
            raise ValueError(
                f"patch_size {patch_size} must divide img_size {img_size}")
        self.img_size = img_size
        self.patch_size = patch_size
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.embed_dropout = embed_dropout
        self.num_superpixels = num_superpixels
        self.compactness = compactness
        self.pooling_type = pooling_type
        self.slic_iters = slic_iters
        self.slic_connectivity = slic_connectivity
        self.patch_embed = PatchEmbedding(patch_size, embed_dim, in_channels,
                                          device=device)
        self.cls_token = nn.Parameter(
            torch.empty(1, 1, embed_dim, device=device))
        self.blocks = nn.ModuleList(make_block() for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5, device=device)
        self.head = nn.Linear(embed_dim, num_classes, device=device)

        if generator is None:
            generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            self.cls_token.copy_(torch.empty(self.cls_token.shape).normal_(
                0.0, 0.02, generator=generator))
        init_weights(self, generator)

    def forward_features(self, images: torch.Tensor,
                         rng: DropoutRNG | None = None) -> torch.Tensor:
        """``[B, H, W, C]`` images to ``[B, D]`` cls-token features."""
        x = sppp_tokens(
            images, self.patch_embed(images.to(self.cls_token.dtype)),
            self.cls_token, patch_size=self.patch_size,
            num_superpixels=self.num_superpixels,
            compactness=self.compactness, pooling_type=self.pooling_type,
            slic_iters=self.slic_iters,
            slic_connectivity=self.slic_connectivity)
        x = inverted_dropout(
            x, self.embed_dropout if self.training else 0.0, rng)
        for block in self.blocks:
            x = block(x, rng=rng)
        return self.norm(x)[:, 0]

    def forward(self, images: torch.Tensor,
                rng: DropoutRNG | None = None) -> torch.Tensor:
        return self.head(self.forward_features(images, rng))

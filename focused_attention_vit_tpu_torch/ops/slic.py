"""SLIC superpixels as fixed-shape batched tensor ops (port of
``focused_attention_vit_tpu/ops/slic.py``).

SLIC is a grid-seeded, locally constrained k-means in (colour, y, x) space:
Gaussian pre-smoothing (scipy's 4-sigma truncation, symmetric edges), seeds
on skimage's regular grid (or an aspect-matched grid of exactly R cells
where skimage's would not give R), the metric
``d^2 = d_colour^2 + (m / S)^2 d_xy^2`` restricted to each centroid's
+-2 step window, ``n_iter - 1`` centroid updates (a cluster that captures no
pixel keeps its centroid), and a last assignment that falls back to the
unwindowed nearest centroid where no window reaches. Batched over
``[B, H, W, C]`` where JAX vmaps; every result is per image.

Connectivity (skimage's default, which the reference inherits) has three
forms, chosen by ``enforce_connectivity``:

* ``True``: the device pass :func:`_enforce_connectivity` (4-connected
  components by a segmented min-scan fixpoint, at most 4 merge passes of
  components below ``MIN_SIZE_FACTOR`` of the mean segment size, a batched
  reduce to at most R components, dense ranks in scan order);
* ``"host"``: ``native/connectivity.cpp`` on the host (skimage's exact BFS
  semantics), the labels copied off the device once a batch and back;
* ``False``: none. ``"auto"`` is the device pass up to
  ``AUTO_CONNECTIVITY_MAX_PIXELS`` pixels and the host above.

Whatever the caller's dtype and autocast state, SLIC reads the pixels in f32
with autocast off, as XLA computes it on the pipeline's f32 images. The call
runs inside a ``torch.profiler`` range named ``slic``.
"""

from __future__ import annotations

import numpy as np
import torch

# "auto" connectivity: the device pass up to this many pixels (64^2 covers
# CIFAR-native inputs), the host pass above.
AUTO_CONNECTIVITY_MAX_PIXELS = 64 * 64
# skimage's min_size_factor: components smaller than this share of the mean
# segment size are merged (device and host passes alike).
MIN_SIZE_FACTOR = 0.5


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    # scipy.ndimage.gaussian_filter truncates at 4 sigma.
    radius = max(1, int(4.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _symmetric_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of a length-n axis padded by r on both sides in numpy's
    ``symmetric`` mode (scipy's ``reflect``: a b c -> b a | a b c | c b)."""
    i = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def gaussian_blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur over the H and W axes of ``[..., H, W, C]``,
    computed in f32 (tap by tap, in JAX's order) and cast back to the
    input's dtype."""
    if sigma <= 0:
        return image
    k = torch.as_tensor(_gaussian_kernel1d(sigma), device=image.device)
    r = (k.shape[0] - 1) // 2

    def conv_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
        n = x.shape[dim]
        xp = x.index_select(dim, _symmetric_index(n, r, x.device))
        out = torch.zeros_like(x)
        for t in range(k.shape[0]):
            out = out + k[t] * xp.narrow(dim, t, n)
        return out

    out = conv_axis(image.float(), image.dim() - 3)
    out = conv_axis(out, image.dim() - 2)
    return out.to(image.dtype)


def _grid_seeds(h: int, w: int, num_segments: int) -> np.ndarray:
    """Seed coordinates ``[R, 2]`` (y, x): skimage's isotropic grid (step
    ``round(sqrt(h*w/R))`` from ``step // 2``) whenever it gives exactly R
    seeds, as at 32^2 and 224^2 with R = 16; otherwise an aspect-matched
    grid of exactly R cell centres, since the token count is static."""
    step = max(1, int(round(np.sqrt(h * w / num_segments))))
    ys = np.arange(step // 2, h, step, dtype=np.float32)
    xs = np.arange(step // 2, w, step, dtype=np.float32)
    if len(ys) * len(xs) == num_segments:
        yy, xx = np.meshgrid(ys, xs, indexing="ij")
        return np.stack([yy.reshape(-1), xx.reshape(-1)],
                        axis=-1).astype(np.float32)
    gh = max(1, int(round(np.sqrt(num_segments * h / w))))
    gw = int(np.ceil(num_segments / gh))
    while gh * gw < num_segments:
        gw += 1
    ys = (np.arange(gh) + 0.5) * (h / gh)
    xs = (np.arange(gw) + 0.5) * (w / gw)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    seeds = np.stack([yy.reshape(-1), xx.reshape(-1)], axis=-1)
    return seeds[:num_segments].astype(np.float32)


def _kmeans(img: torch.Tensor, num_segments: int, compactness: float,
            n_iter: int) -> torch.Tensor:
    """The k-means core on blurred f32 ``[B, H, W, C]``: ``[B, H, W]``
    int64 labels before connectivity (JAX ``_slic_single``)."""
    b, h, w, c = img.shape
    dev = img.device
    r = num_segments
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    feats = img.reshape(b, h * w, c)
    sq = (feats ** 2).sum(-1, keepdim=True)  # [B, P, 1]
    # The grid interval S, the metric's spatial weight (m / S)^2 and
    # skimage's +-2 step window (int() bounds, _slic.pyx).
    interval = float(np.sqrt(h * w / num_segments))
    spatial_w = (compactness / interval) ** 2
    step_px = float(max(1, int(round(interval))))

    seeds = torch.as_tensor(_grid_seeds(h, w, num_segments), device=dev)
    sy = seeds[:, 0].long().clamp(0, h - 1)
    sx = seeds[:, 1].long().clamp(0, w - 1)
    c_color = img[:, sy, sx, :]  # [B, R, C]
    c_pos = seeds.expand(b, r, 2)  # [B, R, 2] (y, x)

    def distances(c_color, c_pos):
        """Windowed ``[B, P, R]`` distances (inf outside every window) and
        the unwindowed ones. The spatial terms are separable: ``[B, H, R]``
        and ``[B, W, R]`` broadcast over the pixel grid."""
        d_color = (sq - 2.0 * torch.bmm(feats, c_color.transpose(1, 2))
                   + (c_color ** 2).sum(-1)[:, None, :])
        cy, cx = c_pos[:, None, :, 0], c_pos[:, None, :, 1]  # [B, 1, R]
        dy = ys[None, :, None] - cy  # [B, H, R]
        dx = xs[None, :, None] - cx  # [B, W, R]
        d_xy = (dy * dy)[:, :, None, :] + (dx * dx)[:, None, :, :]
        d = d_color + spatial_w * d_xy.reshape(b, h * w, r)
        in_y = ((ys[None, :, None] >= torch.trunc(cy - 2.0 * step_px))
                & (ys[None, :, None] <= torch.trunc(cy + 2.0 * step_px)))
        in_x = ((xs[None, :, None] >= torch.trunc(cx - 2.0 * step_px))
                & (xs[None, :, None] <= torch.trunc(cx + 2.0 * step_px)))
        in_win = (in_y[:, :, None, :] & in_x[:, None, :, :]).reshape(
            b, h * w, r)
        return torch.where(in_win, d, torch.inf), d

    grid = torch.stack([ys.repeat_interleave(w), xs.repeat(h)], dim=-1)
    data = torch.cat([feats, grid.expand(b, h * w, 2)], dim=-1)  # [B, P, C+2]
    classes = torch.arange(r, device=dev)
    # skimage runs assign -> update n_iter times and keeps the last
    # assignment: the labels see n_iter - 1 updates. In the loop a pixel
    # that no window reaches stays unlabelled and moves no centroid.
    for _ in range(max(0, n_iter - 1)):
        d_masked, _ = distances(c_color, c_pos)
        d_min, labels = d_masked.min(-1)
        onehot = ((labels[..., None] == classes)
                  & torch.isfinite(d_min)[..., None]).float()  # [B, P, R]
        raw_counts = onehot.sum(1)  # [B, R]
        counts = raw_counts.clamp_min(1.0)[..., None]
        sums = torch.bmm(onehot.transpose(1, 2), data)  # [B, R, C+2]
        new_color = sums[..., :c] / counts
        new_pos = sums[..., c:] / counts
        # A cluster that captured no pixel keeps its centroid (skimage:
        # ``if not mask.any(): continue``).
        has = (raw_counts > 0.0)[..., None]
        c_color = torch.where(has, new_color, c_color)
        c_pos = torch.where(has, new_pos, c_pos)
    d_masked, d_full = distances(c_color, c_pos)
    d_min, labels = d_masked.min(-1)
    labels = torch.where(torch.isfinite(d_min), labels, d_full.argmin(-1))
    return labels.reshape(b, h, w)


def _seg_min_scan(comp: torch.Tensor, seg: torch.Tensor, dim: int,
                  reverse: bool) -> torch.Tensor:
    """Min-propagate ids along ``dim`` within runs of equal ``seg`` label:
    a segmented inclusive min-scan, here in log2(n) Hillis-Steele steps
    (JAX: one ``associative_scan``; the result is the same)."""
    if reverse:
        comp, seg = comp.flip(dim), seg.flip(dim)
    n = seg.shape[dim]
    same = seg == seg.roll(1, dims=dim)  # continues the run of its left
    same.narrow(dim, 0, 1).fill_(False)
    v = comp
    off = 1
    while off < n:
        s_hi, v_hi = same.narrow(dim, off, n - off), v.narrow(dim, off, n - off)
        s_lo, v_lo = same.narrow(dim, 0, n - off), v.narrow(dim, 0, n - off)
        head_s, head_v = same.narrow(dim, 0, off), v.narrow(dim, 0, off)
        v = torch.cat([head_v, torch.where(s_hi, torch.minimum(v_lo, v_hi),
                                           v_hi)], dim)
        same = torch.cat([head_s, s_lo & s_hi], dim)
        off *= 2
    return v.flip(dim) if reverse else v


def _connected_components(seg: torch.Tensor) -> torch.Tensor:
    """4-connected components of ``[B, H, W]`` labels: each pixel's id is
    the smallest flat index of its component (so ids order by scan-order
    discovery, as skimage's BFS). The fixpoint of row and column segmented
    min-scans; an image that has converged is unchanged by another
    sweep."""
    b, h, w = seg.shape
    comp = torch.arange(h * w, device=seg.device).reshape(1, h, w).expand(
        b, h, w)
    while True:
        new = comp
        for dim, reverse in ((2, False), (2, True), (1, False), (1, True)):
            new = _seg_min_scan(new, seg, dim, reverse)
        if torch.equal(new, comp):
            return new
        comp = new


def _adjacent_component(comp: torch.Tensor, big: int) -> torch.Tensor:
    """``[B, P]``: for each component id, the smallest id of a 4-adjacent
    different component; ``big`` where there is none, and for ids that are
    no component."""
    b, h, w = comp.shape
    cand = torch.full_like(comp, big)
    padded = torch.nn.functional.pad(comp, (1, 1, 1, 1), value=big)
    for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        nb = padded[:, 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]
        cand = torch.minimum(cand, torch.where(nb != comp, nb, big))
    return torch.full((b, h * w), big, dtype=comp.dtype,
                      device=comp.device).scatter_reduce(
        1, comp.reshape(b, -1), cand.reshape(b, -1), "amin")


def _enforce_connectivity(seg: torch.Tensor, num_segments: int,
                          min_size_factor: float = MIN_SIZE_FACTOR
                          ) -> torch.Tensor:
    """The device connectivity pass on ``[B, H, W]`` labels (JAX
    ``_enforce_connectivity``, per image): relabel 4-connected components,
    merge components smaller than ``min_size_factor * H * W / R`` into
    their smallest-id neighbour (at most 4 passes, chains resolved by
    pointer jumping), then, while more than R components live, keep the R
    largest (size, then smaller id) and merge every other one into its
    smallest-id neighbour where that neighbour is kept or has a smaller id
    (so chains are acyclic), and rank the survivors densely in scan order,
    clipped to [0, R). Each loop runs while any image needs it; an image
    that is done keeps its labels, as under JAX's vmap."""
    b, h, w = seg.shape
    p = h * w
    big = p
    min_size = int(round(min_size_factor * (h * w / num_segments)))
    ids = torch.arange(p, device=seg.device).expand(b, p)

    def sizes_of(comp):
        return torch.zeros(b, p, dtype=comp.dtype,
                           device=comp.device).scatter_add_(
            1, comp.reshape(b, p), torch.ones_like(comp).reshape(b, p))

    def relabel(comp, mapping, jumps):
        for _ in range(jumps):
            mapping = mapping.gather(1, mapping)
        return mapping.gather(1, comp.reshape(b, p)).reshape(b, h, w)

    comp = _connected_components(seg)
    changed = torch.ones(b, dtype=torch.bool, device=seg.device)
    for _ in range(4):
        if not bool(changed.any()):
            break
        sizes = sizes_of(comp)
        adj = _adjacent_component(comp, big)
        small = (sizes > 0) & (sizes < min_size) & (adj < big)
        new = relabel(comp, torch.where(small, adj, ids), 2)
        comp = torch.where(changed[:, None, None], new, comp)
        changed = changed & small.any(1)

    def live_count(comp):
        return (sizes_of(comp) > 0).sum(1)

    r = num_segments
    while True:
        active = live_count(comp) > r
        if not bool(active.any()):
            break
        sizes = sizes_of(comp)
        live = sizes > 0
        # Keep the R largest live components, the smaller id first among
        # equal sizes: the R-th largest size, then as many of the ties at
        # that size as slots remain, smallest ids first.
        szl = torch.where(live, sizes, -1)
        kth = szl.topk(r, dim=1).values[:, r - 1:r]
        above = live & (sizes > kth)
        slots = r - above.sum(1, keepdim=True)
        eq = live & (sizes == kth)
        eq_ids = (-torch.where(eq, -ids, -(p + 1)).topk(r, dim=1).values)
        thr = eq_ids.gather(1, (slots - 1).clamp(0, r - 1))
        keep = above | (eq & (slots > 0) & (ids <= thr))
        adj = _adjacent_component(comp, big)
        target = adj.clamp(0, p - 1)
        allowed = (adj < big) & (keep.gather(1, target) | (adj < ids))
        mapping = torch.where(live & ~keep & allowed, adj, ids)
        # 2^6-deep chain resolution, as JAX: a chain left unresolved keeps
        # the count above R and costs one more pass.
        new = relabel(comp, mapping, 6)
        comp = torch.where(active[:, None, None], new, comp)

    rep = torch.zeros(b, p, dtype=comp.dtype, device=comp.device).scatter_(
        1, comp.reshape(b, p), 1)
    rank = rep.cumsum(1) - 1
    return rank.gather(1, comp.reshape(b, p)).clamp_max(r - 1).reshape(
        b, h, w)


def _host_connectivity(labels: torch.Tensor, num_segments: int
                       ) -> torch.Tensor:
    """``native/connectivity.cpp`` on ``[B, H, W]`` labels: one copy to the
    host, the C++ threaded over the batch, one copy back."""
    from focused_attention_vit_tpu_torch.ops.native_connectivity import (
        enforce_connectivity_host,
    )

    h, w = labels.shape[1:]
    min_size = int(round(MIN_SIZE_FACTOR * (h * w / num_segments)))
    host = labels.to("cpu", torch.int32).numpy()
    out = enforce_connectivity_host(host, min_size, num_segments)
    return torch.from_numpy(out).to(labels.device)


def slic_segment(images: torch.Tensor, num_segments: int = 16,
                 compactness: float = 0.1, sigma: float = 1.0,
                 n_iter: int = 10,
                 enforce_connectivity: "bool | str" = "auto"
                 ) -> torch.Tensor:
    """SLIC labels of ``[B, H, W, C]`` (or ``[H, W, C]``) images, in any
    standardisation (clustering runs in the images' own channel space):
    int32 ``[B, H, W]`` (or ``[H, W]``) in [0, R). ``enforce_connectivity``
    is ``"auto"``, ``True`` (the device pass), ``"host"`` or ``False``, as
    the module docstring says."""
    if enforce_connectivity not in ("auto", "host", True, False):
        raise ValueError(
            f"enforce_connectivity must be 'auto', 'host', True or False, "
            f"got {enforce_connectivity!r}")
    single = images.dim() == 3
    if single:
        images = images[None]
    h, w = images.shape[1:3]
    mode = enforce_connectivity
    if mode == "auto":
        mode = True if h * w <= AUTO_CONNECTIVITY_MAX_PIXELS else "host"
    with torch.profiler.record_function("slic"), torch.no_grad(), \
            torch.autocast(images.device.type, enabled=False):
        img = gaussian_blur(images.float(), sigma)
        labels = _kmeans(img, num_segments, compactness, n_iter)
        if mode == "host":
            labels = _host_connectivity(labels, num_segments)
        elif mode:
            labels = _enforce_connectivity(labels, num_segments)
        labels = labels.to(torch.int32)
    return labels[0] if single else labels

"""Philox4x32-10 in PyTorch integer tensor ops: the plain version of
``csrc/philox.cuh``, the counter-based generator that draws the dropout
masks of the window band and of the fused short-S attention inside the CUDA
kernels.

On the CPU the ops draw their masks here; on the card the kernels draw the
same bits from the same (counter, key), so one seed gives one mask on both.
All arithmetic is on int64 tensors holding 32-bit words: each 32x32-bit
product is split into 16-bit halves so that nothing overflows 63 bits.

The band keys each draw on (seed, b*h row, window slot, query), never on the
tiling: counter ``(i, o // 4, row & 0xFFFFFFFF, row >> 32)``, key
``(seed & 0xFFFFFFFF, seed >> 32)``, and the bits of slot o are word
``o % 4`` of the output. A slot is kept iff its bits are at least
``keep_threshold(rate)``, the JAX kernel's rule (``mhla_band_roll.py``
:107-108). JAX's TPU generator draws other bits: the dropout stream is not
the JAX package's (SURVEY.md §7), only its rate and independence are.

The fused attention keys each draw on (seed, b*h row, query i, key j). The
four words of one Philox call go to the four keys that one lane of a
tensor-core accumulator owns in a row of a 16-key chunk: counter
``(i, 4 * (j // 16) + (j % 8) // 2, row & 0xFFFFFFFF, row >> 32)``, the same
key, and the bits of key j are word ``j % 2 + 2 * ((j % 16) // 8)``. A
weight is kept by the band's rule.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of ``m * x`` for a 32-bit constant m and
    an int64 tensor x of 32-bit words."""
    p_lo = m * (x & 0xFFFF)  # < 2^48
    p_hi = m * (x >> 16)     # < 2^48
    t = ((p_hi & 0xFFFF) << 16) + p_lo  # < 2^49
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(counter, key: tuple[int, int]):
    """Ten Philox rounds on a counter of four int64 tensors of 32-bit words
    (broadcastable) and a key of two 32-bit ints; returns four tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """Keep a slot iff its 32-bit word is at least this."""
    return min(int(rate * 2**32), 2**32 - 1)


def band_keep_bits(rows: int, window_size: int, seq_len: int, seed: int,
                   device=None) -> torch.Tensor:
    """The band's dropout words: int64 ``[rows, W, S]`` of 32-bit values,
    entry ``[row, o, i]`` deciding slot o of query i in row ``row``."""
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    groups = -(-window_size // 4)
    i = torch.arange(seq_len, dtype=torch.int64, device=device)
    g = torch.arange(groups, dtype=torch.int64, device=device)
    row = torch.arange(rows, dtype=torch.int64, device=device)
    counter = (
        i.view(1, 1, -1),
        g.view(1, -1, 1),
        (row & _MASK32).view(-1, 1, 1),
        (row >> 32).view(-1, 1, 1),
    )
    words = philox4x32_10(counter, (seed & _MASK32, seed >> 32))
    words = [x.expand(rows, groups, seq_len) for x in words]
    # [rows, groups, 4, S] -> slot o = 4 * group + word.
    bits = torch.stack(words, dim=2).reshape(rows, 4 * groups, seq_len)
    return bits[:, :window_size]


def band_keep_mask(rows: int, window_size: int, seq_len: int, rate: float,
                   seed: int, device=None) -> torch.Tensor:
    """Bool ``[rows, W, S]``: True where the slot is kept."""
    bits = band_keep_bits(rows, window_size, seq_len, seed, device)
    return bits >= keep_threshold(rate)


def mha_keep_bits(rows: int, seq_len: int, seed: int,
                  device=None) -> torch.Tensor:
    """The fused attention's dropout words: int64 ``[rows, S, S]`` of
    32-bit values, entry ``[row, i, j]`` deciding key j of query i in row
    ``row``."""
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    chunks = -(-seq_len // 16)
    i = torch.arange(seq_len, dtype=torch.int64, device=device)
    g = torch.arange(4 * chunks, dtype=torch.int64, device=device)
    row = torch.arange(rows, dtype=torch.int64, device=device)
    counter = (
        i.view(1, -1, 1),
        g.view(1, 1, -1),
        (row & _MASK32).view(-1, 1, 1),
        (row >> 32).view(-1, 1, 1),
    )
    words = philox4x32_10(counter, (seed & _MASK32, seed >> 32))
    words = [x.expand(rows, seq_len, 4 * chunks) for x in words]
    # [rows, S, chunk c, pair t, word (hi, lo)] -> key 16c + 8hi + 2t + lo.
    bits = torch.stack(words, dim=-1).view(rows, seq_len, chunks, 4, 2, 2)
    bits = bits.permute(0, 1, 2, 4, 3, 5).reshape(rows, seq_len, 16 * chunks)
    return bits[:, :, :seq_len]


def mha_keep_mask(rows: int, seq_len: int, rate: float, seed: int,
                  device=None) -> torch.Tensor:
    """Bool ``[rows, S, S]``: True where the weight is kept."""
    return mha_keep_bits(rows, seq_len, seed, device) >= keep_threshold(rate)

"""Owen-scrambled padded 4D Sobol (counterpart of pathtracer/sampling/sobol.py).

Same counter-based contract as rng.py: every draw is a pure hash of
(pixel, sample, depth, salt, seed), bit for bit the JAX package's.
Each (pixel, depth, salt, seed) group is its own scrambled copy of the
first four Sobol dimensions; the sample index is Owen-scrambled per
group (a shuffle that keeps every power-of-two prefix a (0, m, s)-net)
and each output dimension is Owen-scrambled with its own key (Burley,
"Practical Hash-based Owen Scrambling", JCGT 2020).

u32 words ride in int64, masked with `& 0xFFFFFFFF` after every `+`
and `<<`; products go through rng._mul32, which never relies on signed
overflow (three of the Laine-Karras constants are above 2^31).
"""

from __future__ import annotations

import numpy as np
import torch

from pathtracer_torch import tracing
from pathtracer_torch.sampling.rng import M32, _mul32


def _direction_vectors() -> np.ndarray:
    """First four Sobol dimensions as [4, 32] u32 direction vectors.

    Dim 0 is the van der Corput sequence (v_k = 2^(31-k)); dims 1-3 use
    the Joe-Kuo (s, a, m) parameters with the standard recurrence
    v_k = a_1 v_{k-1} ^ ... ^ a_{s-1} v_{k-s+1} ^ v_{k-s} ^ (v_{k-s}>>s).
    """
    dims = [np.array([np.uint32(1) << (31 - k) for k in range(32)],
                     np.uint32)]
    joe_kuo = [(1, 0, [1]), (2, 1, [1, 3]), (3, 1, [1, 3, 1])]
    for s, a, m in joe_kuo:
        v = np.zeros(32, np.uint32)
        for k in range(s):
            v[k] = np.uint32(m[k]) << np.uint32(31 - k)
        for k in range(s, 32):
            x = v[k - s] ^ (v[k - s] >> np.uint32(s))
            for j in range(1, s):
                if (a >> (s - 1 - j)) & 1:
                    x ^= v[k - j]
            v[k] = x
        dims.append(v)
    return np.stack(dims)  # [4, 32]


_DIRS = _direction_vectors().astype(np.int64)


def reverse_bits(x):
    """Reverse the 32 bits of each u32 word (int64 tensor)."""
    x = x & M32
    x = ((x >> 16) | (x << 16)) & M32
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    return x


def _laine_karras(x, seed):
    """Random permutation where each bit depends only on LOWER bits
    (Laine & Karras 2011 via Burley 2020); in the bit-reversed domain a
    hash-approximate Owen scramble."""
    x = (x + seed) & M32
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def owen_scramble(x, seed):
    """Nested-uniform (Owen) scramble of u32 fixed-point values in [0,1)."""
    return reverse_bits(_laine_karras(reverse_bits(x), seed))


def sobol4(index):
    """u32 sample indices int64[...] -> int64[..., 4] raw Sobol points.

    Gray-code (Antonov-Saleev) ordering, the convention of
    scipy.stats.qmc.Sobol.
    """
    index = index & M32
    index = index ^ (index >> 1)
    dirs = tracing.device_tensor(_DIRS, index.device)       # [4, 32]
    acc = torch.zeros(index.shape + (4,), dtype=torch.int64,
                      device=index.device)
    for k in range(32):
        bit = (index >> k) & 1
        acc = acc ^ (bit[..., None] * dirs[:, k])
    return acc


def scrambled_sobol4(sample, group_key4):
    """Shuffled + scrambled 4D Sobol point for each lane.

    sample: u32 int64[...] global sample index (frame * spp + s).
    group_key4: u32 int64[..., 4] per-(pixel, depth, salt, seed) hash;
    component 0 keys the index shuffle, 1-3 and a re-hash the dimension
    scrambles.
    """
    idx = owen_scramble(sample & M32, group_key4[..., 0])
    pts = sobol4(idx)
    s1 = group_key4[..., 1]
    s2 = group_key4[..., 2]
    s3 = group_key4[..., 3]
    s0 = _laine_karras(s1 ^ 0x9E3779B9, s2)
    return torch.stack([owen_scramble(pts[..., 0], s0),
                        owen_scramble(pts[..., 1], s1),
                        owen_scramble(pts[..., 2], s2),
                        owen_scramble(pts[..., 3], s3)], dim=-1)

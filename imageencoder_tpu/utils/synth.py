"""Seeded synthetic inputs at real sizes (the original fixtures' pixels are
not in this repository): images with flat regions, edges, a gradient and
sensor-like noise, and YUV420p video of such a frame panning across.
"""

from __future__ import annotations

import numpy as np


def seeded_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """[h, w] u8: 16x16 flat patches, a left-to-right ramp, N(0, 6) noise."""
    base = np.kron(rng.integers(0, 256, (h // 16, w // 16)),
                   np.ones((16, 16)))
    ramp = np.linspace(0, 40, w)[None, :]
    return np.clip(base * 0.8 + ramp + rng.normal(0, 6, (h, w)),
                   0, 255).astype(np.uint8)


def seeded_video(rng: np.random.Generator, w: int, h: int, n: int):
    """(YUV420p bytes, Y planes u8 [n, h, w]): an 8x8-patch texture panning
    by (2, 3) px per frame with N(0, 3) noise; chroma is left at zero."""
    base = np.kron(rng.integers(0, 256, (h // 8, w // 8)), np.ones((8, 8)))
    frames, ys = [], []
    for f in range(n):
        y = np.clip(np.roll(base, (f * 2, f * 3), (0, 1))
                    + rng.normal(0, 3, base.shape), 0, 255).astype(np.uint8)
        ys.append(y)
        frames.append(y.tobytes() + bytes(w * h // 2))
    return b"".join(frames), np.stack(ys)

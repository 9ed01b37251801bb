"""TAA.

Counterpart of modules/taa.js: 9-frame history averaging with a
3x3 neighborhood min/max clip-clamp against the current frame, plus the
zero-sum pseudo-random camera jitter sequence. The GL texture ring
(taa.js:109-127) becomes a functional [9, H, W, 4] history array.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

FRAMES = 9  # taa.js:6


class TAAState(NamedTuple):
    history: jnp.ndarray  # [FRAMES, H, W, 4], newest at index 0

    @staticmethod
    def create(height: int, width: int) -> "TAAState":
        return TAAState(history=jnp.zeros((FRAMES, height, width, 4), dtype=jnp.float32))


def neighborhood_clamp(cur: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """3x3 min/max of the current frame with zero-padded borders (texelFetch
    out of bounds -> 0), matching the GLSL loop (taa.js:45-52).

    This is TAA's ONLY cross-pixel read — history averaging is pointwise —
    so the sharded-halo pipeline computes it over a 1-row halo-exchanged
    strip and crops, keeping everything else strip-local."""
    pad = jnp.pad(cur, ((1, 1), (1, 1), (0, 0)))
    stac = jnp.stack([pad[1 + dy:pad.shape[0] - 1 + dy, 1 + dx:pad.shape[1] - 1 + dx]
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=0)
    min_rgb = jnp.minimum(stac.min(axis=0), 1.0)
    max_rgb = jnp.maximum(stac.max(axis=0), 0.0)
    return min_rgb, max_rgb


def taa_apply(state: TAAState, frame: jnp.ndarray,
              clamp=None) -> tuple[jnp.ndarray, TAAState]:
    """Push `frame` [H,W,4] and average clamped history (taa.js:25-58).
    `clamp` optionally supplies precomputed (min_rgb, max_rgb)."""
    history = jnp.concatenate([frame[None], state.history[:-1]], axis=0)
    cur = history[0]
    min_rgb, max_rgb = neighborhood_clamp(cur) if clamp is None else clamp

    out = cur
    for i in range(1, FRAMES):
        out = out + jnp.clip(history[i], min_rgb, max_rgb)
    out = out / FRAMES
    return out, TAAState(history=history)


def gen_zero_sum_jitter(n: int = FRAMES, seed: int = 0) -> np.ndarray:
    """n pseudo-random 2D vectors summing to zero (taa.js:139-155)."""
    rng = np.random.default_rng(seed)
    vecs = np.zeros((n, 2))
    vecs[0] = [0, 1]
    vecs[1] = [1, 0]
    combined = np.array([1.0, 1.0])
    for i in range(2, n):
        for j in range(2):
            lo = max(-min(i + 1, n - 1 - i), combined[j] - 1)
            hi = min(min(i + 1, n - 1 - i), combined[j] + 1)
            r = np.sign(rng.random() - 0.5) * np.sqrt(rng.random() * 0.5)
            vecs[i][j] = 0.5 * ((hi + lo) + (hi - lo) * r) - combined[j]
            combined[j] += vecs[i][j]
    return vecs


class Jitter:
    """Per-frame camera jitter cycling through the zero-sum set
    (taa.js:129-136)."""

    def __init__(self, seed: int = 0):
        self.vecs = gen_zero_sum_jitter(seed=seed)
        self.current = 0

    def next(self, width: int, height: int) -> tuple[float, float]:
        self.current = (self.current + 1) % FRAMES
        scale = 0.3 / min(width, height)
        return (self.vecs[self.current][0] * scale, self.vecs[self.current][1] * scale)

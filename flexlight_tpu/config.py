"""Render configuration.

Counterpart of `modules/config.js:1-16`: same knob names and
defaults. The config is consumed at jit-compile time (every field shapes
the compiled program), so it is a frozen, hashable dataclass — changing a
knob triggers a recompile, mirroring the reference's shader-recompile-on-
change behavior (pathtracerWGL2.js:264-267).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    samples_per_ray: int = 1
    render_quality: float = 1.0
    max_reflections: int = 5
    min_importancy: float = 0.3
    first_passes: int = 3
    second_passes: int = 3
    temporal: bool = True
    temporal_samples: int = 4
    filter: bool = False
    # Denoise-chain flavor (not a reference knob): "fast" tile-quantizes
    # the per-pixel blur radius key (post.common.tileize_blur_key) to its
    # per-tile mean; "compat" replicates the
    # reference's per-pixel key arithmetic-exactly (the parity-proof
    # mode). Edge-stopping gates are identical in both modes.
    filter_mode: str = "fast"
    hdr: bool = True
    antialiasing: str | None = "fxaa"
    # RNG flavor (not a reference knob): "hash" = GLSL noise() compat
    # (golden/oracle parity), "counter" = murmur3-quality counter hash
    # (SURVEY §7 RNG plan). Changing it changes the sample sequence.
    rng: str = "hash"

    # camelCase read aliases for 1:1 example ports
    @property
    def samplesPerRay(self):
        return self.samples_per_ray

    @property
    def maxReflections(self):
        return self.max_reflections

    @property
    def minImportancy(self):
        return self.min_importancy

    @property
    def temporalSamples(self):
        return self.temporal_samples

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

#!/usr/bin/env python
"""Image-delta report: filter_mode="fast" vs "compat" on real frames.

Renders each BASELINE filter scene through the full pipeline in both
modes (same seed/history) and records the per-scene delta statistics:
mean abs diff, p99, outlier fraction (> 5/255), and a luminance SSIM.
Writes docs/parity/fast_vs_compat.json — the committed evidence that the
fast denoise mode stays within filter tolerance of the exact chain
(VERDICT r2 item 1).

Usage: python scripts/fast_vs_compat.py [--size WxH] [--scenes a,b,c]
CPU fallback: python scripts/fast_vs_compat.py --cpu --size 192x108
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))
sys.path.insert(0, os.path.join(ROOT, "tests"))


def ssim(a, b):
    """Global SSIM on luminance (sufficient for a whole-image delta
    summary; windowed SSIM adds little for near-identical images)."""
    import numpy as np

    la = a.mean(axis=-1)
    lb = b.mean(axis=-1)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ma, mb = la.mean(), lb.mean()
    va, vb = la.var(), lb.var()
    cov = ((la - ma) * (lb - mb)).mean()
    return float((2 * ma * mb + c1) * (2 * cov + c2)
                 / ((ma ** 2 + mb ** 2 + c1) * (va + vb + c2)))


def render(engine_mod, w, h, mode, frames=4):
    import jax.numpy as jnp

    from flexlight_tpu import Config
    from flexlight_tpu.models.pathtracer import frame_pipeline
    from flexlight_tpu.post.taa import TAAState
    from flexlight_tpu.post.temporal import TemporalState

    engine = engine_mod.build_scene()
    if isinstance(engine, tuple):
        engine = engine[0]
    config = Config(temporal=True, temporal_samples=4, filter=True,
                    antialiasing="fxaa", samples_per_ray=1,
                    max_reflections=5, filter_mode=mode)
    engine.canvas = (w, h)
    engine.config = config
    engine.renderer = "pathtracer"
    renderer = engine.renderer
    renderer.render()
    scheme = renderer._resolved_scheme()
    buffers = renderer._buffers
    view = jnp.asarray(engine.camera.view_matrix(w, h))
    pos = jnp.asarray(engine.camera.position)
    temporal = TemporalState.create(config.temporal_samples, h, w)
    taa = TAAState.create(h, w)
    out = None
    for i in range(frames):  # fill the temporal ring like a real run
        out, temporal, taa = frame_pipeline(
            buffers, pos, view, jnp.float32(float(i % 4)), temporal, taa,
            width=w, height=h, config=config, scheme=scheme)
    import numpy as np

    return np.asarray(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="1920x1080")
    ap.add_argument("--scenes", default="theater,cornell,emissive")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "docs", "parity", "fast_vs_compat.json"))
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"

    from flexlight_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import importlib

    import numpy as np

    w, h = (int(x) for x in args.size.split("x"))
    report = {"size": [w, h],
              "pipeline": "temporal+filter(3+3+final)+fxaa, spp 1, mr 5",
              "scenes": {}}
    for name in args.scenes.split(","):
        mod = importlib.import_module(name)
        fast = render(mod, w, h, "fast")
        compat = render(mod, w, h, "compat")
        diff = np.abs(fast - compat)
        report["scenes"][name] = {
            "mean_abs_diff": round(float(diff.mean()), 6),
            "p99_abs_diff": round(float(np.percentile(diff, 99)), 6),
            "max_abs_diff": round(float(diff.max()), 6),
            "outlier_frac_gt_5_255": round(
                float((diff > 5.0 / 255.0).mean()), 6),
            "ssim_luma": round(ssim(fast, compat), 6),
        }
        print(name, report["scenes"][name], flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print("wrote", args.out)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Render every example scene to docs/gallery/<name>.png.

The committed gallery is the visual counterpart of the reference's
screenshots/ directory: one small CPU-rendered frame per ported example
scene (examples/*.py), each using its own scene config/animation via the
example's CLI. Run after renderer-visible changes:

    python scripts/make_gallery.py [only ...]
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "docs", "gallery")

# name -> (frames, size): enough temporal frames to settle, CPU-friendly
# sizes; heavy scenes (dragon 43.6k tris, theater, bike) render smaller.
SCENES = {
    "cornell": (8, 192),
    "example1": (8, 192),
    "example2": (8, 192),
    "emissive": (8, 192),
    "wave": (8, 192),
    "eth": (8, 192),
    "obj": (8, 192),
    "dragon": (3, 144),
    "theater": (4, 144),
    "bike": (3, 144),
}


def main():
    only = set(sys.argv[1:]) or set(SCENES)
    os.makedirs(OUT, exist_ok=True)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    failed = []
    for name, (frames, size) in SCENES.items():
        if name not in only:
            continue
        out = os.path.join(OUT, f"{name}.png")
        cmd = [sys.executable, os.path.join(ROOT, "examples", f"{name}.py"),
               str(frames), str(size), out]
        print(f"== {name} ({frames} frames @ {size}px)", flush=True)
        rc = subprocess.run(cmd, env=env, cwd=ROOT, timeout=3600).returncode
        if rc != 0:
            failed.append(name)
            print(f"   FAILED rc={rc}", flush=True)
    if failed:
        sys.exit(f"gallery failures: {failed}")
    print(f"gallery written to {OUT}")


if __name__ == "__main__":
    main()

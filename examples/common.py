"""Shared harness for example scenes (the loader.js analogue)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from flexlight_tpu import FlexLight
from flexlight_tpu.scene.scene import Texture
from flexlight_tpu.utils.image import write_png

# Reference assets (objects/*.obj, textures/*.jpg) if mounted
ASSET_DIR = os.environ.get("FLEXLIGHT_ASSETS", "/root/reference")


def asset(path: str) -> str:
    return os.path.join(ASSET_DIR, path)


def load_texture(path: str) -> Texture:
    """Image file -> Texture (browser Image analogue)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    # n * (1/255) so AtlasTable's u8 storage round-trips bit-exactly
    return Texture(np.asarray(img, dtype=np.float32) * np.float32(1.0 / 255.0))


def run(engine: FlexLight, name: str, default_frames: int = 4,
        default_size: int = 192, animate=None):
    """CLI runner: <frames> <size applied via canvas> <out.png>.

    `animate(t)` is called before each frame with the frame index —
    the setInterval-animation analogue. When FLEXLIGHT_SETTINGS names a
    file, persisted knobs are restored before the run and saved after
    (the loader.js localStorage analogue).
    """
    from flexlight_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else default_frames
    size = int(sys.argv[2]) if len(sys.argv) > 2 else default_size
    out = sys.argv[3] if len(sys.argv) > 3 else f"{name}_out.png"
    persist = os.environ.get("FLEXLIGHT_SETTINGS")
    if persist:
        from flexlight_tpu.utils.settings import apply_settings

        apply_settings(engine, persist)
    engine.canvas = (size, size)
    engine.renderer.render()
    img = None
    for t in range(frames):
        if animate is not None:
            animate(t)
            engine.renderer.update_primary_light_sources()
        img = engine.renderer.render_frame()
    write_png(out, img)
    if persist:
        from flexlight_tpu.utils.settings import save_settings

        save_settings(engine.config, renderer=engine.renderer.type,
                      path=persist)
    print(f"wrote {out}  fps={engine.renderer.fps:.2f}")
    return img

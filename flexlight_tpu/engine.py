"""Engine facade.

Counterpart of `flexlight.js:13-142`: holds camera / config /
scene / renderer and hot-swaps the renderer family by string key. The
`api` axis ('webgl2' | 'webgpu') of the reference selected between two GPU
backends of the same renderer; here it selects between the full pipeline
('tpu', default) and the reduced WGPU-parity pipeline ('simple') — the
reference's WebGPU backend implements shadowed-diffuse only
(pathtracer.wgsl:221-238), which `models.simple` mirrors.
"""

from __future__ import annotations

from .camera import Camera
from .config import Config
from .scene.scene import Scene


class FlexLight:
    def __init__(self, canvas=None):
        """`canvas` may be a (width, height) tuple or None (headless)."""
        self._api = "tpu"
        self._canvas = canvas if canvas is not None else (512, 512)
        self._camera = Camera()
        self._config = Config()
        self._scene = Scene()
        self._renderer_name = "rasterizer"  # flexlight.js:34 defaults to rasterizer
        self._renderer = None
        self._io_name = "web"
        self._io = None
        self._ui = None

    # --- properties mirroring flexlight.js:39-104 ---
    @property
    def canvas(self):
        return self._canvas

    @canvas.setter
    def canvas(self, value):
        self._canvas = value
        self._renderer = None

    @property
    def api(self):
        return self._api

    @api.setter
    def api(self, value):
        if value not in ("tpu", "simple", "webgl2", "webgpu"):
            raise ValueError(f"unknown api {value!r}")
        self._api = value
        self._renderer = None

    @property
    def camera(self):
        return self._camera

    @camera.setter
    def camera(self, camera):
        self._camera = camera
        self._scene.camera = camera  # flexlight.js:96 mirrors it onto the scene
        if self._renderer is not None:
            self._renderer.camera = camera

    @property
    def config(self):
        return self._config

    @config.setter
    def config(self, config):
        self._config = config
        if self._renderer is not None:
            self._renderer.config = config

    @property
    def scene(self):
        return self._scene

    @scene.setter
    def scene(self, scene):
        self._scene = scene
        self._renderer = None

    @property
    def ui(self):
        """Center-ray object picker (flexlight.js:36 instantiates UI;
        modules/ui.js). Tracks the current scene/camera."""
        if self._ui is None:
            from .interaction import UI

            self._ui = UI(self._scene, self._camera)
        self._ui.scene = self._scene
        self._ui.camera = self._camera
        return self._ui

    @property
    def io(self):
        if self._io is None:
            from .interaction import WebIo

            self._io = WebIo(self.renderer, self._camera)
        return self._io

    @io.setter
    def io(self, value):
        if value != "web":
            raise ValueError(f"Io option {value!r} doesn't exist.")
        self._io_name = value
        self._io = None

    @property
    def renderer(self):
        if self._renderer is None:
            self._renderer = self._make_renderer(self._renderer_name)
        return self._renderer

    @renderer.setter
    def renderer(self, name):
        """Hot-swap by string key (flexlight.js:106-129)."""
        if self._renderer is not None:
            self._renderer.halt()
        self._renderer_name = name
        self._renderer = self._make_renderer(name)

    def _make_renderer(self, name: str):
        from .models.pathtracer import PathTracer
        from .models.rasterizer import Rasterizer
        from .models.simple import SimplePathTracer

        width, height = self._canvas
        # 'webgpu' api maps both renderer names to the simple pipeline,
        # mirroring flexlight.js:115-123 (rasterizer+webgpu -> PathTracerWGPU).
        if self._api in ("webgpu", "simple"):
            return SimplePathTracer(width, height, self._scene, self._camera, self._config)
        if name == "pathtracer":
            return PathTracer(width, height, self._scene, self._camera, self._config)
        if name == "rasterizer":
            return Rasterizer(width, height, self._scene, self._camera, self._config)
        raise ValueError(f"Renderer option {name!r} on api {self._api!r} doesn't exist.")

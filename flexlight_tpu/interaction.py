"""Interaction layer: fly-camera IO and center-ray object picking.

Counterparts of `modules/io.js` (pointer-lock WASD fly camera —
here a headless key-state integrator with the same axis map and integration
math) and `modules/ui.js` (CPU ray-pick over the scene graph using the host
ray/triangle test).
"""

from __future__ import annotations

import math
import time

from .utils import mathlib

# key -> signed axis (io.js:5-12)
TRANSLATION_MAP = {
    "right": 1, "left": -1,
    "down": -2, "up": 2,
    "backward": -3, "forward": 3,
}

DEFAULT_KEYMAP = {
    "KeyW": "forward", "KeyA": "left", "KeyS": "backward", "KeyD": "right",
    "Space": "up", "ShiftLeft": "down",
}


class WebIo:
    """Time-integrated fly camera (io.js:14-107). Drive it with
    key_down/key_up/mouse_move + update(now)."""

    def __init__(self, renderer=None, camera=None):
        self.camera = camera
        self.renderer = renderer
        self.mouse_x = 4.0
        self.mouse_y = 2.0
        self.movement_speed = 0.01
        self._key_map = {k: TRANSLATION_MAP[v] for k, v in DEFAULT_KEYMAP.items()}
        self._pressed = {k: False for k in self._key_map}
        self._movement = [0.0, 0.0, 0.0]
        self._saved_time = time.perf_counter() * 1000.0
        self.is_listening = True

    def register_key(self, key: str, value: str):
        self._key_map[key] = TRANSLATION_MAP[value]
        self._pressed[key] = False

    def _update_movement(self, value: int):
        self._movement[abs(value) - 1] += math.copysign(1, value)

    def key_down(self, key: str, now_ms: float | None = None):
        if key in self._pressed and not self._pressed[key]:
            self.update(now_ms)
            self._pressed[key] = True
            self._update_movement(self._key_map[key])

    def key_up(self, key: str, now_ms: float | None = None):
        if key in self._pressed and self._pressed[key]:
            self.update(now_ms)
            self._pressed[key] = False
            self._update_movement(-self._key_map[key])

    def reset_movement(self):
        for k in self._pressed:
            self._pressed[k] = False
        self._movement = [0.0, 0.0, 0.0]

    def update(self, now_ms: float | None = None):
        """Integrate movement into the camera (io.js:51-59)."""
        if not self.is_listening or self.camera is None:
            return
        now_ms = time.perf_counter() * 1000.0 if now_ms is None else now_ms
        c = self.camera
        diff = (now_ms - self._saved_time) * self.movement_speed
        c.x += diff * (self._movement[0] * math.cos(c.fx) - self._movement[2] * math.sin(c.fx))
        c.y += diff * self._movement[1]
        c.z += diff * (self._movement[2] * math.cos(c.fx) + self._movement[0] * math.sin(c.fx))
        self._saved_time = now_ms

    def mouse_move(self, dx: float, dy: float, width: int = 512, height: int = 512):
        """Mouse-look with fy clamped to +-pi/2 (io.js:99-105)."""
        if not self.is_listening or self.camera is None:
            return
        mx = self.mouse_x / width * dx
        my = self.mouse_y / height * dy
        self.camera.fx -= mx
        if 2.0 * abs(self.camera.fy + my) < math.pi:
            self.camera.fy += my


class UI:
    """Center-ray object picker (ui.js:1-65)."""

    def __init__(self, scene, camera):
        self.scene = scene
        self.camera = camera
        self.selected = None

    def pick_center(self):
        """Select the object under the view center, or None (ui.js:13-34)."""
        origin = [self.camera.x, self.camera.y, self.camera.z]
        direction = [
            -math.sin(self.camera.fx) * math.cos(self.camera.fy),
            -math.sin(self.camera.fy),
            math.cos(self.camera.fx) * math.cos(self.camera.fy),
        ]
        result = self.get_object_in_center(self.scene.queue, origin, direction)
        if result is not None and result[0] != float("inf"):
            self.selected = result[1]
        else:
            self.selected = None
        return self.selected

    def get_object_in_center(self, part, origin, direction):
        """Recursive least-distance search (ui.js:37-64)."""
        if isinstance(part, (list, tuple)) or getattr(part, "indexable", False):
            if len(part) == 0:
                return None
            least = None
            for child in part:
                t = self.get_object_in_center(child, origin, direction)
                if t is None:
                    continue
                if least is None or t[0] < least[0]:
                    least = t
            return least
        v = part.vertices.reshape(-1, 3)
        n = part.normal
        dist = float("inf")
        for t in range(part.length):
            d = mathlib.ray_triangle(origin, direction,
                                     v[t * 3], v[t * 3 + 1], v[t * 3 + 2], n)
            dist = min(dist, d)
        return (dist, part)

"""Transform registry.

Counterpart of the reference's `Transform` class
(modules/scene.js:490-612): a registry of 3x3 rotation*scale matrices and
positions. Index 0 is always the identity (scene.js:590-593). The device
consumes a packed [M, 2, 3, 3] rotation array (even slot = forward matrix
for shading, odd slot = Moore-Penrose inverse for transforming rays into
object space; scene.js:500-521) and a matching [M, 2, 3] shift array
(pos, -pos).
"""

from __future__ import annotations

import numpy as np

from ..utils import mathlib


class TransformRegistry:
    """Holds all live transforms; one per Scene by default."""

    def __init__(self):
        self.used: list[bool] = []
        self.transform_list: list["Transform"] = []
        # Monotonic mutation counter: bumped on every acquire and every
        # Transform setter, so per-frame consumers (the renderers' UBO
        # refresh, pathtracerWGL2.js:361-363) can skip the rebuild AND
        # the host->device upload when nothing moved.
        self.version = 0
        # Slot 0 defaults to the identity transform (scene.js:590-593).
        Transform(registry=self)

    @property
    def count(self) -> int:
        return len(self.transform_list)

    def _acquire(self, transform: "Transform") -> int:
        self.version += 1
        for i, used in enumerate(self.used):
            if not used:
                self.used[i] = True
                self.transform_list[i] = transform
                return i
        self.used.append(True)
        self.transform_list.append(transform)
        return len(self.used) - 1

    def build_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """Pack (rotations[M,2,3,3], shifts[M,2,3]) float32 device arrays.

        Mirrors Transform.buildWGL2Arrays (scene.js:500-521): even index =
        forward rotation*scale, odd = pseudo-inverse; shift, -shift.
        """
        m = max(self.count, 1)
        rotations = np.zeros((m, 2, 3, 3), dtype=np.float32)
        shifts = np.zeros((m, 2, 3), dtype=np.float32)
        for i, t in enumerate(self.transform_list):
            matrix = t.matrix
            rotations[i, 0] = matrix
            rotations[i, 1] = mathlib.moore_penrose(matrix)
            shifts[i, 0] = t.position
            shifts[i, 1] = -np.asarray(t.position)
        return rotations, shifts


# Module-level default registry, mirroring the reference's static class state
# (scene.js:496-498). Scenes may own private registries for test isolation.
GLOBAL_REGISTRY = None


def global_registry() -> TransformRegistry:
    global GLOBAL_REGISTRY
    if GLOBAL_REGISTRY is None:
        GLOBAL_REGISTRY = TransformRegistry()
    return GLOBAL_REGISTRY


def reset_global_registry() -> None:
    global GLOBAL_REGISTRY
    GLOBAL_REGISTRY = None


class Transform:
    """A rotation+scale+translation assigned to primitives by number."""

    def __init__(self, matrix=None, registry: TransformRegistry | None = None):
        self._rotation_matrix = np.eye(3, dtype=np.float64) if matrix is None else np.asarray(matrix, dtype=np.float64)
        self._position = np.zeros(3, dtype=np.float64)
        self._scale = 1.0
        self.registry = registry if registry is not None else global_registry()
        self.number = self.registry._acquire(self)

    @property
    def matrix(self) -> np.ndarray:
        """Scale-multiplied rotation matrix (scene.js:545-549)."""
        return self._scale * self._rotation_matrix

    @property
    def position(self) -> np.ndarray:
        return self._position

    def move(self, x: float, y: float, z: float) -> None:
        self._position = np.array([x, y, z], dtype=np.float64)
        self.registry.version += 1

    def rotate_axis(self, normal, theta: float) -> None:
        self._rotation_matrix = mathlib.rotation_axis(mathlib.normalize(normal), theta)
        self.registry.version += 1

    def rotate_spherical(self, theta: float, psi: float) -> None:
        self._rotation_matrix = mathlib.rotation_spherical(theta, psi)
        self.registry.version += 1

    def scale(self, s: float) -> None:
        self._scale = float(s)
        self.registry.version += 1

    # camelCase aliases for 1:1 example ports (reference API, scene.js:555-587)
    rotateAxis = rotate_axis
    rotateSpherical = rotate_spherical

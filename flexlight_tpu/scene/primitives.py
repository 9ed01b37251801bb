"""Scene primitives.

Counterpart of the reference's primitive classes
(modules/scene.js:614-921). Every primitive keeps two packed per-triangle
records that the flattener memcpys into the device arrays:

- geometry record, 12 floats/triangle: v0,v1,v2 (9f), [9]=transform id,
  [10]=kind (2=triangle) (scene.js:628-634).
- attribute ("scene") record, 28 floats/triangle: normals 9f, uvs 6f,
  textureNums 3f (-1 = inline value), albedo 3f, rme 3f, tpo 3f
  (scene.js:636-641).
"""

from __future__ import annotations

import numpy as np

from ..utils import mathlib
from .transform import Transform

GEOMETRY_FLOATS = 12
ATTRIBUTE_FLOATS = 28

# Kind codes in geometry slot [10] (pathtracer_fragment.glsl:204-207)
KIND_SENTINEL = 0.0
KIND_BVH_NODE = 1.0
KIND_TRIANGLE = 2.0


class Primitive:
    """Base class holding `length` triangles with shared material."""

    def __init__(self, length: int, vertices, normal, uvs):
        self.indexable = False
        self.static = False
        self.length = int(length)

        self._vertices = np.asarray(vertices, dtype=np.float32).reshape(-1)
        self._normal = np.asarray(normal, dtype=np.float32).reshape(3)
        self._normals = np.tile(self._normal, self.length * 3)
        self._uvs = np.asarray(uvs, dtype=np.float32).reshape(-1)

        self._texture_nums = np.array([-1, -1, -1], dtype=np.float32)
        self._albedo = np.array([1, 1, 1], dtype=np.float32)
        self._rme = np.array([1, 0, 0], dtype=np.float32)
        self._tpo = np.array([0, 0, 1], dtype=np.float32)
        self._transform: Transform | None = None

        self.geometry_buffer = np.zeros(self.length * GEOMETRY_FLOATS, dtype=np.float32)
        self.attribute_buffer = np.zeros(self.length * ATTRIBUTE_FLOATS, dtype=np.float32)
        self._build_buffers()

    def _build_buffers(self) -> None:
        """Re-serialize per-triangle records (scene.js:628-643)."""
        g = self.geometry_buffer.reshape(self.length, GEOMETRY_FLOATS)
        s = self.attribute_buffer.reshape(self.length, ATTRIBUTE_FLOATS)
        g[:, 0:9] = self._vertices.reshape(self.length, 9)
        g[:, 9] = self.transform_num
        g[:, 10] = KIND_TRIANGLE
        s[:, 0:9] = self._normals.reshape(self.length, 9)
        s[:, 9:15] = self._uvs.reshape(self.length, 6)
        s[:, 15:18] = self._texture_nums
        s[:, 18:21] = self._albedo
        s[:, 21:24] = self._rme
        s[:, 24:27] = self._tpo

    # --- reference-parity property surface (scene.js:645-730) ---
    @property
    def vertices(self):
        return self._vertices

    @vertices.setter
    def vertices(self, v):
        self._vertices = np.asarray(v, dtype=np.float32).reshape(-1)
        self._build_buffers()

    @property
    def normals(self):
        return self._normals

    @normals.setter
    def normals(self, ns):
        self._normals = np.asarray(ns, dtype=np.float32).reshape(-1)
        self._normal = self._normals[:3].copy()
        self._build_buffers()

    @property
    def normal(self):
        return self._normal

    @normal.setter
    def normal(self, n):
        self._normal = np.asarray(n, dtype=np.float32).reshape(3)
        self._normals = np.tile(self._normal, self.length * 3)
        self._build_buffers()

    @property
    def uvs(self):
        return self._uvs

    @uvs.setter
    def uvs(self, uv):
        self._uvs = np.asarray(uv, dtype=np.float32).reshape(-1)
        self._build_buffers()

    @property
    def transform(self):
        return self._transform

    @transform.setter
    def transform(self, t):
        self._transform = t
        self._build_buffers()

    @property
    def transform_num(self) -> int:
        return 0 if self._transform is None else self._transform.number

    # JS-parity alias
    transformNum = transform_num

    @property
    def texture_nums(self):
        return self._texture_nums

    @texture_nums.setter
    def texture_nums(self, tn):
        self._texture_nums = np.asarray(tn, dtype=np.float32).reshape(3)
        self._build_buffers()

    @property
    def color(self):
        return self._albedo

    @color.setter
    def color(self, c):
        """0-255 RGB input, stored normalized (scene.js:692-696)."""
        self._albedo = np.asarray(c, dtype=np.float32).reshape(3) / 255.0
        self._build_buffers()

    @property
    def albedo(self):
        return self._albedo

    @albedo.setter
    def albedo(self, a):
        self.color = a

    @property
    def roughness(self):
        return float(self._rme[0])

    @roughness.setter
    def roughness(self, r):
        self._rme[0] = r
        self._build_buffers()

    @property
    def metallicity(self):
        return float(self._rme[1])

    @metallicity.setter
    def metallicity(self, m):
        self._rme[1] = m
        self._build_buffers()

    @property
    def emissiveness(self):
        return float(self._rme[2])

    @emissiveness.setter
    def emissiveness(self, e):
        self._rme[2] = e
        self._build_buffers()

    @property
    def translucency(self):
        return float(self._tpo[0])

    @translucency.setter
    def translucency(self, t):
        self._tpo[0] = t
        self._build_buffers()

    @property
    def ior(self):
        return float(self._tpo[2])

    @ior.setter
    def ior(self, o):
        self._tpo[2] = o
        self._build_buffers()

    # camelCase alias used by example scenes
    @property
    def textureNums(self):
        return self._texture_nums

    @textureNums.setter
    def textureNums(self, tn):
        self.texture_nums = tn


class Plane(Primitive):
    """Quad = 2 triangles [c0,c1,c2] + [c2,c3,c0] (scene.js:747-751).

    Extra positional args (e.g. a 5th normal argument, example1.js:52) are
    accepted and ignored, matching the reference constructor.
    """

    def __init__(self, c0, c1, c2, c3, *_ignored):
        vertices = np.concatenate([
            np.asarray(c0, dtype=np.float32), np.asarray(c1, dtype=np.float32),
            np.asarray(c2, dtype=np.float32), np.asarray(c2, dtype=np.float32),
            np.asarray(c3, dtype=np.float32), np.asarray(c0, dtype=np.float32),
        ])
        normal = mathlib.normalize(mathlib.cross(mathlib.diff(c0, c2), mathlib.diff(c0, c1)))
        uvs = [0, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0]
        super().__init__(2, vertices, normal, uvs)


class Triangle(Primitive):
    """Single triangle (scene.js:753-757)."""

    def __init__(self, a, b, c, *_ignored):
        vertices = np.concatenate([
            np.asarray(a, dtype=np.float32), np.asarray(b, dtype=np.float32),
            np.asarray(c, dtype=np.float32),
        ])
        normal = mathlib.normalize(mathlib.cross(mathlib.diff(a, c), mathlib.diff(a, b)))
        super().__init__(1, vertices, normal, [0, 0, 0, 1, 1, 1])


class Object3D:
    """Indexable container that broadcasts material setters to children
    and supports static baking (scene.js:759-894)."""

    def __init__(self, length: int):
        self.relative_position = [0.0, 0.0, 0.0]
        self.length = int(length)
        self.indexable = True
        self._items: list = [None] * self.length
        self._transform: Transform | None = None
        self._static = False
        self._static_permanent = False
        # Baked buffers when static (scene.js:841-864)
        self.texture_length = 0
        self.buffer_length = 0
        self.id_buffer = None
        self.geometry_buffer = None
        self.attribute_buffer = None
        self.min_max = None

    def __getitem__(self, i):
        return self._items[i]

    def __setitem__(self, i, value):
        self._items[i] = value

    def __len__(self):
        return self.length

    def __iter__(self):
        return iter(self._items)

    @property
    def transform(self):
        return self._transform

    @transform.setter
    def transform(self, t):
        self._transform = t
        for item in self._items:
            if item is not None:
                item.transform = t

    @property
    def transform_num(self) -> int:
        return 0 if self._transform is None else self._transform.number

    def _broadcast(self, name, value):
        for item in self._items:
            if item is not None:
                setattr(item, name, value)

    # Broadcast material setters (scene.js:779-809)
    color = property(None, lambda self, c: self._broadcast("color", c))
    albedo = property(None, lambda self, a: self._broadcast("albedo", a))
    roughness = property(None, lambda self, r: self._broadcast("roughness", r))
    metallicity = property(None, lambda self, m: self._broadcast("metallicity", m))
    emissiveness = property(None, lambda self, e: self._broadcast("emissiveness", e))
    translucency = property(None, lambda self, t: self._broadcast("translucency", t))
    ior = property(None, lambda self, o: self._broadcast("ior", o))
    texture_nums = property(None, lambda self, tn: self._broadcast("texture_nums", tn))
    textureNums = property(None, lambda self, tn: self._broadcast("texture_nums", tn))

    def move(self, x: float, y: float, z: float) -> None:
        """Translate all leaf vertices (scene.js:811-829)."""
        self.relative_position = [x, y, z]
        offset = np.array([x, y, z], dtype=np.float32)
        for item in self._items:
            if item is None:
                continue
            if getattr(item, "indexable", False):
                item.move(x, y, z)
            else:
                v = item.vertices.reshape(-1, 3) + offset
                item.vertices = v.reshape(-1)

    def scale(self, s: float) -> None:
        """Scale leaf vertices about relative_position (scene.js:831-839)."""
        pivot = np.asarray(self.relative_position, dtype=np.float32)
        for item in self._items:
            if item is None:
                continue
            if getattr(item, "indexable", False):
                item.scale(s)
            else:
                v = (item.vertices.reshape(-1, 3) - pivot) * s + pivot
                item.vertices = v.reshape(-1)

    @property
    def static(self) -> bool:
        return self._static

    @static.setter
    def static(self, is_static: bool):
        """Bake (or unbake) the subtree's flattened buffers (scene.js:841-864)."""
        if is_static:
            from .flatten import flatten_graph

            built = flatten_graph(self)
            self.texture_length = built.texture_length
            self.buffer_length = built.buffer_length
            self.id_buffer = built.id_buffer
            self.geometry_buffer = built.geometry
            self.attribute_buffer = built.attributes
            self.min_max = built.min_max
            self._static = True
        else:
            self._static = False
            self.texture_length = 0
            self.buffer_length = 0
            self.geometry_buffer = None
            self.attribute_buffer = None
            self.min_max = None

    @property
    def static_permanent(self) -> bool:
        return self._static_permanent

    @static_permanent.setter
    def static_permanent(self, value: bool):
        """Bake and drop the subtree (scene.js:870-882)."""
        if self._static_permanent and not value:
            raise ValueError("Can't unset static permanent, tree is permanently lost")
        if value:
            self._static_permanent = True
            self.static = True
            self._items = [None] * self.length

    # camelCase aliases
    staticPermanent = static_permanent


class Bounding(Object3D):
    """Array wrapper node in the BVH (scene.js:896-901)."""

    def __init__(self, items, *_scene):
        super().__init__(len(items))
        for i, item in enumerate(items):
            self._items[i] = item
        self.bounding = None  # interleaved [minX,maxX,minY,maxY,minZ,maxZ]


class Cuboid(Object3D):
    """Axis-aligned box of 6 planes with a 2^-16-ish inset bias
    (scene.js:903-921). Faces accessible as .top/.right/.front/.bottom/
    .left/.back and by index."""

    def __init__(self, x, x2, y, y2, z, z2):
        super().__init__(6)
        bias = 0.00152587890625
        x, y, z = x + bias, y + bias, z + bias
        x2, y2, z2 = x2 - bias, y2 - bias, z2 - bias
        self.bounding = [x, x2, y, y2, z, z2]
        self.top = Plane([x, y2, z], [x2, y2, z], [x2, y2, z2], [x, y2, z2])
        self.right = Plane([x2, y2, z], [x2, y, z], [x2, y, z2], [x2, y2, z2])
        self.front = Plane([x2, y2, z2], [x2, y, z2], [x, y, z2], [x, y2, z2])
        self.bottom = Plane([x, y, z2], [x2, y, z2], [x2, y, z], [x, y, z])
        self.left = Plane([x, y2, z2], [x, y, z2], [x, y, z], [x, y2, z])
        self.back = Plane([x, y2, z], [x, y, z], [x2, y, z], [x2, y2, z])
        for i, face in enumerate([self.top, self.right, self.front, self.bottom, self.left, self.back]):
            self._items[i] = face

"""Scene container, BVH builder, and texture constructors.

Counterpart of `modules/scene.js:7-488`. The scene graph is the
same nested-list structure as the reference (`queue` nesting IS the BVH);
`generate_bvh` reproduces the reference's least-straddle median split
(scene.js:62-154) with vectorized NumPy split trials, and
`generate_arrays` flattens to the SoA device arrays (see flatten.py).
"""

from __future__ import annotations

import numpy as np

from ..utils import mathlib
from .flatten import FlattenedScene, flatten_graph
from .primitives import Bounding, Cuboid, Plane, Primitive, Triangle
from .transform import Transform

BVH_MAX_LEAVES_PER_NODE = 4  # scene.js:6
BOUNDING_BIAS = 0.00152587890625  # scene.js:159
MIN_BOUNDING_WIDTH = 1.0 / 256.0  # scene.js:140


class PushList(list):
    """List with a JS-style .push for 1:1 example ports."""

    def push(self, *items):
        self.extend(items)
        return len(self)


class LightSource(list):
    """[x, y, z] position with .intensity / .variation attributes
    monkey-patched on, exactly like the reference's light entries
    (examples/cornell.js:35-37)."""

    intensity: float | None = None
    variation: float | None = None

    def __init__(self, xyz, intensity=None, variation=None):
        super().__init__(xyz)
        if intensity is not None:
            self.intensity = intensity
        if variation is not None:
            self.variation = variation


class Texture:
    """A texture as a [H, W, 3] float32 array in [0, 1]."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, dtype=np.float32)
        assert self.data.ndim == 3 and self.data.shape[2] == 3

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]


def _is_indexable(item) -> bool:
    return isinstance(item, (list, tuple)) or getattr(item, "indexable", False)


class Scene:
    def __init__(self):
        # Light sources and global illumination (scene.js:8-12)
        self.primary_light_sources: list = [LightSource([0, 10, 0])]
        self.default_light_intensity = 200.0
        self.default_light_variation = 0.4
        self.ambient_light = [0.025, 0.025, 0.025]
        # Texture lists consumed by the atlas builder (scene.js:13-16)
        self.textures: list[Texture] = PushList()
        self.pbr_textures: list[Texture] = PushList()
        self.translucency_textures: list[Texture] = PushList()
        self.standard_texture_sizes = [1024, 1024]
        # The queue's nesting is the acceleration structure (scene.js:17-18)
        self.queue = PushList()

    # ------------------------------------------------------------------
    # Texture constructors (scene.js:20-53)
    # ------------------------------------------------------------------
    @staticmethod
    def texture_from_rgb(array, width: int, height: int) -> Texture:
        """RGBA byte array (0-255) -> normalized RGB texture (scene.js:22-39)."""
        a = np.asarray(array, dtype=np.float32).reshape(height, width, 4)
        # n * (1/255) rather than n / 255 so the u8 compact-table storage
        # (AtlasTable) reconstructs these values bit-exactly on device
        return Texture(a[:, :, :3] * np.float32(1.0 / 255.0))

    @staticmethod
    def texture_from_rme(array, width: int, height: int) -> Texture:
        """RME floats in [0,1] packed r,m,e per texel (scene.js:43-50)."""
        a = np.asarray(array, dtype=np.float32).reshape(height, width, 3)
        return Texture(a)

    # TPO textures are built the same way as RME (scene.js:53)
    texture_from_tpo = texture_from_rme

    # camelCase aliases for 1:1 example ports
    textureFromRGB = texture_from_rgb
    textureFromRME = texture_from_rme
    textureFromTPO = texture_from_rme

    # ------------------------------------------------------------------
    # Constructor passthroughs (scene.js:319-327)
    # ------------------------------------------------------------------
    def Transform(self, matrix=None):
        return Transform(matrix)

    def Cuboid(self, x, x2, y, y2, z, z2):
        return Cuboid(x, x2, y, y2, z, z2)

    def Plane(self, c0, c1, c2, c3, *extra):
        return Plane(c0, c1, c2, c3, *extra)

    def Triangle(self, a, b, c):
        return Triangle(a, b, c)

    def Bounding(self, array):
        return Bounding(array)

    # ------------------------------------------------------------------
    # Bounding maintenance (scene.js:56-59, 157-187)
    # ------------------------------------------------------------------
    @staticmethod
    def fits_in_bound(bound, obj) -> bool:
        """Interleaved-AABB containment test (scene.js:56-59)."""
        b = obj.bounding
        return (bound[0] <= b[0] and bound[2] <= b[2] and bound[4] <= b[4]
                and bound[1] >= b[1] and bound[3] >= b[3] and bound[5] >= b[5])

    def update_boundings(self, obj=None):
        """Recompute interleaved [minX,maxX,minY,maxY,minZ,maxZ] boundings
        recursively, inflating internal nodes by +-bias (scene.js:157-187)."""
        if obj is None:
            obj = self.queue
        if _is_indexable(obj):
            if len(obj) == 0:
                min_max = np.zeros(6)
            else:
                min_max = np.asarray(self.update_boundings(obj[0]), dtype=np.float64).copy()
                for child in list(obj)[1:]:
                    b = self.update_boundings(child)
                    for i in range(6):
                        if i % 2 == 0:
                            min_max[i] = min(min_max[i], b[i] - BOUNDING_BIAS)
                        else:
                            min_max[i] = max(min_max[i], b[i] + BOUNDING_BIAS)
        else:
            v = obj.vertices.reshape(-1, 3).astype(np.float64)
            mins, maxs = v.min(axis=0), v.max(axis=0)
            min_max = np.array([mins[0], maxs[0], mins[1], maxs[1], mins[2], maxs[2]])
        try:
            obj.bounding = min_max
        except AttributeError:
            pass  # plain lists can't hold attributes; Bounding nodes can
        return min_max

    # ------------------------------------------------------------------
    # BVH autobuild (scene.js:62-154)
    # ------------------------------------------------------------------
    def generate_bvh(self, objects=None):
        """Median-split BVH with least-straddle axis selection.

        Identical policy to the reference: stop at <=4 leaves or depth >
        log2(n)+8; try the 3 axis-center splits, pick the one with fewest
        objects fitting in neither half (ties -> later axis), require the
        half width > 1/256; 3 buckets (upper / lower / straddle), each
        tightened and recursed (scene.js:70-137).
        """
        if objects is None:
            objects = self.queue
        top = Bounding(list(objects))
        self.update_boundings(top)
        max_depth = np.log2(max(len(top), 1)) + 8

        def divide(node: Bounding, depth: int):
            objs = list(node)
            if len(objs) <= BVH_MAX_LEAVES_PER_NODE or depth > max_depth:
                return node
            bounding = np.asarray(node.bounding, dtype=np.float64)
            center = np.array([
                (bounding[0] + bounding[1]) / 2,
                (bounding[2] + bounding[3]) / 2,
                (bounding[4] + bounding[5]) / 2,
            ])
            # Vectorized split trials over the 3 axes
            child_bounds = np.stack([np.asarray(o.bounding, dtype=np.float64) for o in objs])
            ideal_split = None
            least_on_edge = np.inf
            for axis in range(3):
                lo, hi = bounding[axis * 2], bounding[axis * 2 + 1]
                c = center[axis]
                min_diff = min(hi - c, c - lo)
                # Object straddles if it fits in neither the raised-min nor
                # the lowered-max half (scene.js:64-68).
                fits_upper = child_bounds[:, axis * 2] >= c
                fits_lower = child_bounds[:, axis * 2 + 1] <= c
                on_edge = int(np.sum(~(fits_upper | fits_lower)))
                if least_on_edge >= on_edge and min_diff > MIN_BOUNDING_WIDTH:
                    ideal_split = axis
                    least_on_edge = on_edge
            if ideal_split is None:
                return node  # OPTIMIZATION failed; keep unsplit (scene.js:106-110)
            c = center[ideal_split]
            buckets: list[list] = [[], [], []]
            for o, b in zip(objs, child_bounds):
                if b[ideal_split * 2] >= c:
                    buckets[0].append(o)
                elif b[ideal_split * 2 + 1] <= c:
                    buckets[1].append(o)
                else:
                    buckets[2].append(o)
            children = []
            for bucket in buckets:
                if bucket:
                    bn = Bounding(bucket)
                    self.update_boundings(bn)
                    children.append(divide(bn, depth + 1))
            common = Bounding(children)
            common.bounding = node.bounding
            return common

        return divide(top, 0)

    # camelCase aliases
    generateBVH = generate_bvh
    updateBoundings = update_boundings
    fitsInBound = fits_in_bound

    # ------------------------------------------------------------------
    # Flattening (scene.js:190-316)
    # ------------------------------------------------------------------
    def generate_arrays(self, obj=None) -> FlattenedScene:
        return flatten_graph(self.queue if obj is None else obj)

    generateArraysFromGraph = generate_arrays

    # ------------------------------------------------------------------
    # Light packing (pathtracerWGL2.js:143-165)
    # ------------------------------------------------------------------
    def build_light_array(self) -> np.ndarray:
        """Pack [L, 2, 3]: [x,y,z], [intensity, variation, 0]."""
        lights = [l for l in self.primary_light_sources if l is not None]
        if not lights:
            return np.zeros((1, 2, 3), dtype=np.float32)
        out = np.zeros((len(lights), 2, 3), dtype=np.float32)
        for i, l in enumerate(lights):
            intensity = getattr(l, "intensity", None)
            variation = getattr(l, "variation", None)
            out[i, 0] = [l[0], l[1], l[2]]
            out[i, 1, 0] = self.default_light_intensity if intensity is None else intensity
            out[i, 1, 1] = self.default_light_variation if variation is None else variation
        return out

    # ------------------------------------------------------------------
    # OBJ / MTL import (scene.js:330-487)
    # ------------------------------------------------------------------
    def import_mtl(self, path: str) -> dict:
        """Parse a .mtl file into a {name: material-dict} map (scene.js:438-487).

        Ka -> color*255; Ke -> emissiveness*4 with color rescale; Ns ->
        metallicity/1000; Ni -> ior; d is ignored (disabled in the
        reference, scene.js:470-473).
        """
        materials: dict[str, dict] = {}
        current = None
        with open(path) as f:
            for line in f:
                words = line.split()
                if not words:
                    continue
                key = words[0]
                if key == "newmtl":
                    current = words[1]
                    materials[current] = {}
                elif current is None:
                    continue
                elif key == "Ka":
                    materials[current]["color"] = [255.0 * float(w) for w in words[1:4]]
                elif key == "Ke":
                    vals = [float(w) for w in words[1:4]]
                    emissiveness = max(vals)
                    if emissiveness > 0:
                        materials[current]["emissiveness"] = emissiveness * 4.0
                        materials[current]["color"] = [255.0 / emissiveness * v for v in vals]
                elif key == "Ns":
                    materials[current]["metallicity"] = float(words[1]) / 1000.0
                elif key == "Ni":
                    materials[current]["ior"] = float(words[1])
        return materials

    def import_obj(self, path: str, materials: dict | None = None,
                   fast: bool | None = None):
        """Parse a .obj, build a BVH over its faces, and return the root
        (scene.js:330-436). Quads become Planes, triangles become
        Triangles, with per-face material application.

        `fast` (default: auto) routes through the native C++ loader, which
        returns a pre-baked StaticMesh instead of a tree of Python
        primitives — same flattened layout, ~50x faster at dragon scale.
        """
        if fast is None or fast:
            from .. import native
            from .static_mesh import StaticMesh

            if native.available():
                data = native.load_obj(path)
                if data is not None:
                    return StaticMesh(data, materials)
            if fast:
                raise RuntimeError("native loader unavailable")
        materials = materials or {}
        obj: list[Primitive] = []
        v: list[list[float]] = []
        vt: list[list[float]] = []
        vn: list[list[float]] = []
        cur_material = None

        def resolve(num_str: str, count: int) -> int:
            n = int(num_str) if num_str else 0
            if n < 0:
                n = count + n + 1
            return n

        with open(path) as f:
            for line in f:
                words = line.split()
                if not words:
                    continue
                key = words[0]
                if key == "v":
                    v.append([float(words[1]), float(words[2]), float(words[3])])
                elif key == "vt":
                    vt.append([float(words[1]), float(words[2])])
                elif key == "vn":
                    vn.append([float(words[1]), float(words[2]), float(words[3])])
                elif key == "f":
                    data = []
                    for vertex in words[1:]:
                        parts = vertex.split("/")
                        idx = [resolve(parts[0], len(v))]
                        idx.append(resolve(parts[1], len(vt)) if len(parts) > 1 and parts[1] else 0)
                        idx.append(resolve(parts[2], len(vn)) if len(parts) > 2 and parts[2] else 0)
                        data.append(idx)
                    if len(data) == 4:
                        # Quad -> Plane with reversed winding (scene.js:372-386)
                        prim = Plane(v[data[3][0] - 1], v[data[2][0] - 1],
                                     v[data[1][0] - 1], v[data[0][0] - 1])
                        order = [3, 2, 1, 1, 0, 3]
                    else:
                        prim = Triangle(v[data[2][0] - 1], v[data[1][0] - 1], v[data[0][0] - 1])
                        order = [2, 1, 0]
                    uvs = prim.uvs.copy()
                    normals = prim.normals.copy()
                    for i, index in enumerate(order):
                        if data[index][1] > 0 and data[index][1] - 1 < len(vt):
                            uvs[i * 2:i * 2 + 2] = vt[data[index][1] - 1]
                        if data[index][2] > 0 and data[index][2] - 1 < len(vn):
                            normals[i * 3:i * 3 + 3] = vn[data[index][2] - 1]
                    prim.uvs = uvs
                    prim.normals = normals
                    if cur_material is not None:
                        mat = materials[cur_material]
                        prim.color = mat.get("color", [255, 255, 255])
                        prim.emissiveness = mat.get("emissiveness", 0)
                        prim.metallicity = mat.get("metallicity", 0)
                        prim.roughness = mat.get("roughness", 1)
                        prim.translucency = mat.get("translucency", 0)
                        prim.ior = mat.get("ior", 1)
                    obj.append(prim)
                elif key == "usemtl":
                    if words[1] in materials:
                        cur_material = words[1]
        root = self.generate_bvh(obj)
        self.update_boundings(root)
        return root

    # camelCase aliases
    importObj = import_obj
    importMtl = import_mtl

    # snake/camel property bridges used by example ports
    @property
    def primaryLightSources(self):
        return self.primary_light_sources

    @primaryLightSources.setter
    def primaryLightSources(self, lights):
        self.primary_light_sources = [
            l if isinstance(l, LightSource) or l is None else LightSource(l)
            for l in lights
        ]

    @property
    def ambientLight(self):
        return self.ambient_light

    @ambientLight.setter
    def ambientLight(self, v):
        self.ambient_light = list(v)

    @property
    def standardTextureSizes(self):
        return self.standard_texture_sizes

    @standardTextureSizes.setter
    def standardTextureSizes(self, v):
        self.standard_texture_sizes = list(v)

    @property
    def pbrTextures(self):
        return self.pbr_textures

    @property
    def translucencyTextures(self):
        return self.translucency_textures

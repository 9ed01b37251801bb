"""Scene-graph flattener.

Counterpart of `Scene.generateArraysFromGraph`
(modules/scene.js:190-316). Walks the (possibly manually nested) scene
queue depth-first and emits the packed SoA device arrays:

- geometry [S, 12] float32 — triangle rows (v0,v1,v2, tid, kind=2) and BVH
  rows (aabb_min, aabb_max, skip, _, _, tid, kind=1); kind=0 rows are the
  end-of-list sentinel (scene.js:256-259, pathtracer_fragment.glsl:204-207).
- attributes [S, 28] float32 — normals/uvs/texnums/albedo/rme/tpo.
- id_buffer [T] int32 — triangle slot per drawable triangle (scene.js:267).

S is padded to a multiple of 256 slots, mirroring the reference's
256-triangles-per-texture-row layout (scene.js:294-300). The traversal
contract is identical: linear scan with `i += skip` on AABB miss.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .primitives import ATTRIBUTE_FLOATS, GEOMETRY_FLOATS, KIND_BVH_NODE

SLOTS_PER_ROW = 256


@dataclass
class FlattenedScene:
    texture_length: int          # total texel slots used (triangles + BVH nodes)
    buffer_length: int           # total drawable triangles
    geometry: np.ndarray         # [S, 12] float32
    attributes: np.ndarray       # [S, 28] float32
    id_buffer: np.ndarray        # [T] int32
    min_max: np.ndarray          # [6] scene AABB (min.xyz, max.xyz)


def _is_indexable(item) -> bool:
    return isinstance(item, (list, tuple)) or getattr(item, "indexable", False)


def _count(item) -> tuple[int, int]:
    """Probe pass: (texel slots, triangle count) (scene.js:205-221)."""
    if getattr(item, "static", False):
        return item.texture_length, item.buffer_length
    if _is_indexable(item):
        if len(item) == 0:
            return 0, 0
        slots, tris = 1, 0
        for child in item:
            s, t = _count(child)
            slots += s
            tris += t
        return slots, tris
    return item.length, item.length


def flatten_graph(root) -> FlattenedScene:
    slots, tris = _count(root)
    padded = max(SLOTS_PER_ROW, int(np.ceil(max(slots, 1) / SLOTS_PER_ROW)) * SLOTS_PER_ROW)
    geometry = np.zeros((padded, GEOMETRY_FLOATS), dtype=np.float32)
    attributes = np.zeros((padded, ATTRIBUTE_FLOATS), dtype=np.float32)
    id_buffer = np.zeros(tris, dtype=np.int32)

    state = {"slot": 0, "tri": 0}

    def fill(item) -> np.ndarray | None:
        """DFS fill; returns subtree AABB [min.xyz, max.xyz] (scene.js:224-282)."""
        if getattr(item, "static", False):
            pos = state["slot"]
            n = item.texture_length
            geometry[pos:pos + n] = item.geometry_buffer.reshape(-1, GEOMETRY_FLOATS)[:n]
            attributes[pos:pos + n] = item.attribute_buffer.reshape(-1, ATTRIBUTE_FLOATS)[:n]
            id_buffer[state["tri"]:state["tri"] + item.buffer_length] = pos + item.id_buffer
            state["slot"] += n
            state["tri"] += item.buffer_length
            return np.asarray(item.min_max, dtype=np.float64).copy()

        if _is_indexable(item):
            if len(item) == 0:
                return None
            node_slot = state["slot"]
            state["slot"] += 1
            cur = None
            for child in item:
                box = fill(child)
                if box is None:
                    continue
                if cur is None:
                    cur = box
                else:
                    cur[0:3] = np.minimum(cur[0:3], box[0:3])
                    cur[3:6] = np.maximum(cur[3:6], box[3:6])
            if cur is None:
                cur = np.zeros(6)
            # Backpatch AABB + skip count (texel slots in subtree) so the
            # traversal can jump over it on miss (scene.js:254-259).
            geometry[node_slot, 0:6] = cur
            geometry[node_slot, 6] = state["slot"] - node_slot - 1
            geometry[node_slot, 9] = getattr(item, "transform_num", 0) if not isinstance(item, (list, tuple)) else 0
            geometry[node_slot, 10] = KIND_BVH_NODE
            return cur

        # Leaf primitive: memcpy its baked records (scene.js:264-267).
        pos = state["slot"]
        n = item.length
        geometry[pos:pos + n] = item.geometry_buffer.reshape(n, GEOMETRY_FLOATS)
        attributes[pos:pos + n] = item.attribute_buffer.reshape(n, ATTRIBUTE_FLOATS)
        id_buffer[state["tri"]:state["tri"] + n] = np.arange(pos, pos + n, dtype=np.int32)
        state["slot"] += n
        state["tri"] += n
        v = item.vertices.reshape(-1, 3).astype(np.float64)
        return np.concatenate([v.min(axis=0), v.max(axis=0)])

    min_max = fill(root)
    if min_max is None:
        min_max = np.zeros(6)
    return FlattenedScene(
        texture_length=slots,
        buffer_length=tris,
        geometry=geometry,
        attributes=attributes,
        id_buffer=id_buffer,
        min_max=min_max,
    )

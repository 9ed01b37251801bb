"""FlexLight-TPU: a real-time render engine in JAX.

A ground-up JAX/XLA rebuild of the capabilities of FlexLight
(`arbobendik/web-ray-tracer`): a Monte-Carlo path tracer and a direct-
lighting rasterizer-equivalent over a scene graph of triangles / planes /
cuboids with PBR materials, temporal accumulation, edge-aware denoising,
and FXAA/TAA post-processing — built from batched ray
wavefronts, packet BVH traversal, image-tile sharding over a device mesh).
"""

from .camera import Camera
from .config import Config
from .engine import FlexLight
from .scene.primitives import Bounding, Cuboid, Object3D, Plane, Primitive, Triangle
from .scene.scene import LightSource, Scene, Texture
from .scene.transform import Transform

__all__ = [
    "Bounding", "Camera", "Config", "Cuboid", "FlexLight", "LightSource",
    "Object3D", "Plane", "Primitive", "Scene", "Texture", "Transform", "Triangle",
]

__version__ = "0.1.0"

"""dirt_tpu: a differentiable triangle rasterizer in JAX, run on NVIDIA GPUs.

A from-scratch JAX/Pallas framework with the capabilities of the reference
DIRT renderer (see SURVEY.md): z-buffered triangle rasterization with
perspective-correct barycentric interpolation of arbitrary vertex
attributes, exact interior gradients plus occlusion-aware approximate
silhouette gradients, and a pure-JAX graphics-math stack (cameras,
lighting, textures, deferred shading) on top — scaling over several cards
via image-tile and face sharding.
"""

from dirt_tpu.rasterise_ops import (
    rasterise,
    rasterise_batch,
    rasterise_with_aux,
    suggest_raster_config,
)
from dirt_tpu.ops.raster import RasterConfig

__all__ = [
    "rasterise",
    "rasterise_batch",
    "rasterise_with_aux",
    "suggest_raster_config",
    "RasterConfig",
]
__version__ = "0.1.0"

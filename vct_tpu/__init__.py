"""vct_tpu — a differentiable voxel-cone-tracing framework in JAX.

Built from scratch in JAX (plus one Pallas-Triton kernel) with the capabilities of the OpenGL 4.3
reference (AlerianEmperor/Voxel-Cone-Tracing): scene voxelization into a
radiance grid, mip-pyramid construction, and per-pixel diffuse (6-cone) +
specular (1-cone) cone marching with cone-traced ambient occlusion and
2-bounce global illumination.

Design differences from the reference (see SURVEY.md §7):
  * raster pipeline -> array programs (jit end to end; primary visibility
    is a binned raycast kernel)
  * shadow map + PCF -> differentiable shadow cone (configurable; a
    rasterized shadow-map path also exists for parity)
  * last-write-wins imageStore voxelization -> deterministic scatter-mean
  * hardware quadrilinear textureLod -> explicit gather+lerp mip sampling
"""

from vct_tpu.config import (
    ConeSetConfig,
    GridConfig,
    LightConfig,
    RenderConfig,
    ShadowConfig,
    VCTConfig,
    preset,
)

__all__ = [
    "ConeSetConfig",
    "GridConfig",
    "LightConfig",
    "RenderConfig",
    "ShadowConfig",
    "VCTConfig",
    "preset",
]

__version__ = "0.1.0"

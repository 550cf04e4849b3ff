"""Rasterized shadow map + PCF — reference-parity shadow mode ("map").

Replaces the depth-only raster pass (Voxel_Cone_Tracing.h:80-105, K1 in
SURVEY.md §2.2) with a deterministic scatter-min of surface samples into
the light's ortho grid: the program has no rasterizer, and the voxelization
stage already generates a dense surface sampling, so the same samples
build the depth map.  Each sample splats a 3x3-texel footprint so the
point sampling closes raster coverage holes (documented deviation — a
hole would read as depth 1.0 = lit and leak light).

Light transform pinned to the reference:
  view = lookAt(lightDirection, 0, (0,1,0)), proj = ortho(+-120, -100..100)
  (Voxel_Cone_Tracing.h:83-85); shadow coords pre-biased to [0,1]
  (Voxelization.vs:18-19); depth texture CLAMP_TO_EDGE + bilinear
  (Voxel_Cone_Tracing.h:92-95); PCF 5x5 with `current - bias <= closest`
  (VoxelConeTracing.fs:132-163).  The main pass's 25-tap sum is divided by
  9 ("shadow *= 0.111f", fs:158 — brightens 2.78x) under
  pcf_normalization="reference" and by 25 under "correct"; the voxelize
  pass always divides by 25 (Voxelization.fs:46).

The "map" mode is the parity oracle for the default "volume"/"percone"
shadow cones — non-differentiable through the depth compare, exactly like
the original.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vct_tpu.config import VCTConfig

Array = jax.Array


def light_matrix(cfg: VCTConfig) -> np.ndarray:
    """Biased light view-projection: world -> [0,1]^2 uv x [0,1] depth.

    0.5 * (ortho(-e,e,-e,e,n,f) @ lookAt(lightDir, 0, up)) + 0.5, the
    DepthModelViewProjectionMatrix pipeline (Voxel_Cone_Tracing.h:83-85)
    with the [0,1] bias the vertex shaders apply (Voxelization.vs:18-19).
    """
    eye = np.asarray(cfg.light.direction, np.float64)
    up = np.array([0.0, 1.0, 0.0])
    fwd = -eye / np.linalg.norm(eye)              # toward center (origin)
    s = np.cross(fwd, up)
    if np.linalg.norm(s) < 1e-8:                  # light along +y: degenerate up
        s = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    s /= np.linalg.norm(s)
    u = np.cross(s, fwd)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = s, u, -fwd
    view[0, 3] = -s @ eye
    view[1, 3] = -u @ eye
    view[2, 3] = fwd @ eye

    e = cfg.shadow.ortho_extent
    near, far = cfg.shadow.ortho_near, cfg.shadow.ortho_far
    proj = np.zeros((4, 4))
    proj[0, 0] = 1.0 / e
    proj[1, 1] = 1.0 / e
    proj[2, 2] = -2.0 / (far - near)
    proj[2, 3] = -(far + near) / (far - near)
    proj[3, 3] = 1.0

    bias = np.eye(4)
    bias[:3, :3] *= 0.5
    bias[:3, 3] = 0.5
    return (bias @ proj @ view).astype(np.float32)


def project(matrix: Array, p: Array) -> Tuple[Array, Array]:
    """World points (..., 3) -> (uv (..., 2), depth (...)) in light space."""
    m = jnp.asarray(matrix)
    h = p @ m[:3, :3].T + m[:3, 3]
    return h[..., :2], h[..., 2]


def build_shadow_map(cfg: VCTConfig, positions: Array) -> Array:
    """Scatter-min surface-sample depths into the (S, S) light grid.

    map[iy, ix] = min depth of samples landing in that texel's 3x3
    neighborhood; empty texels stay at 1.0 (far plane).
    """
    size = cfg.shadow.map_size
    uv, depth = project(light_matrix(cfg), positions)
    ix = jnp.floor(uv[..., 0] * size).astype(jnp.int32)
    iy = jnp.floor(uv[..., 1] * size).astype(jnp.int32)
    shadow_map = jnp.ones((size, size), depth.dtype)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            x = jnp.clip(ix + dx, 0, size - 1)
            y = jnp.clip(iy + dy, 0, size - 1)
            inside = ((ix + dx >= 0) & (ix + dx < size) &
                      (iy + dy >= 0) & (iy + dy < size) &
                      (depth >= 0.0) & (depth <= 1.0))
            d = jnp.where(inside, depth, 1.0)
            shadow_map = shadow_map.at[y, x].min(d)
    return shadow_map


def _bilinear_depth(shadow_map: Array, uv: Array) -> Array:
    """GL_LINEAR + CLAMP_TO_EDGE fetch of the depth texture
    (Voxel_Cone_Tracing.h:92-95); texel centers at (i+0.5)/S."""
    s = shadow_map.shape[0]
    x = uv[..., 0] * s - 0.5
    y = uv[..., 1] * s - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = jnp.clip(x0.astype(jnp.int32), 0, s - 1)
    y0 = jnp.clip(y0.astype(jnp.int32), 0, s - 1)
    x1 = jnp.clip(x0 + 1, 0, s - 1)
    y1 = jnp.clip(y0 + 1, 0, s - 1)
    flat = shadow_map.reshape(-1)
    d00 = flat[y0 * s + x0]
    d01 = flat[y0 * s + x1]
    d10 = flat[y1 * s + x0]
    d11 = flat[y1 * s + x1]
    return ((d00 * (1 - fx) + d01 * fx) * (1 - fy)
            + (d10 * (1 - fx) + d11 * fx) * fy)


def pcf_shadow(cfg: VCTConfig, shadow_map: Array, position: Array,
               normalization: str) -> Array:
    """5x5 PCF: mean of `current - bias <= closest` over the kernel
    (VoxelConeTracing.fs:141-158). normalization: "main" applies the
    config's pcf_normalization ("reference" = the /9 quirk), "voxelize"
    always divides by the true tap count (Voxelization.fs:46)."""
    uv, current = project(light_matrix(cfg), position)
    size = cfg.shadow.map_size
    r = cfg.shadow.pcf_radius
    bias = cfg.shadow.pcf_bias
    total = jnp.zeros(position.shape[:-1], position.dtype)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            off = jnp.asarray([dx / size, dy / size], position.dtype)
            closest = _bilinear_depth(shadow_map, uv + off)
            total = total + (current - bias <= closest)
    taps = (2 * r + 1) ** 2
    if normalization == "main" and cfg.shadow.pcf_normalization == "reference":
        return total * 0.111                       # fs:158 quirk (25 taps / 9)
    return total / taps

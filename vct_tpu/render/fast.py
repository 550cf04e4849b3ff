"""The GPU camera pass: binned primary visibility + XLA deferred shading.

  1. pad the frame to whole 16x64-pixel strips and put each strip's rays
     together (ops/binrast_pallas.strip_order);
  2. bin the scene's triangles to the strips and find every pixel's
     closest hit with the Pallas-Triton kernel (ops/binrast_pallas);
  3. alpha-mask see-through (fs:169-172 `discard`): re-cast the rays whose
     hit samples albedo alpha below the threshold, past that hit, with the
     same kernel and binning (renderer.alpha_mask_recast);
  4. renderer.shade_gbuffer (VoxelConeTracing.fs:165-228) over pixel
     chunks, as renderer.render_rays does, so shading intermediates at
     1080p stay chunk-sized.

Every config runs here: shade_gbuffer handles map/volume/percone shadows,
field and per-cone GI and anisotropic mips.  The image equals
render_rays' up to closest-hit ties at equal t.  Only the raycast is a
kernel; gradients w.r.t. materials, light and radiance flow through the
XLA shading exactly as in render_rays.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from vct_tpu.config import VCTConfig
from vct_tpu.ops import binrast_pallas as BR
from vct_tpu.render.gbuffer import (DeviceScene, hits_to_gbuffer,
                                    pinhole_constants)
from vct_tpu.render.renderer import (MaterialTable, VoxelState,
                                     alpha_mask_recast, light_direction,
                                     shade_gbuffer)

Array = jax.Array


def _strip_rays(dirs: Array):
    """(H, W, 3) rays -> (padded image (hp, wp, 3), strip-ordered (n, 3))."""
    h, w = dirs.shape[:2]
    hp = -(-h // BR.STRIP_H) * BR.STRIP_H
    wp = -(-w // BR.STRIP_W) * BR.STRIP_W
    dimg = jnp.pad(dirs, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    return dimg, BR.strip_order(dimg)


@functools.partial(jax.jit, static_argnames=("interpret",))
def raycast_image(ds: DeviceScene, origins: Array, dirs: Array,
                  interpret: bool = False):
    """The camera pass's primary visibility alone: closest hits of the
    (H, W) camera rays as (t (H, W), +inf on a miss; tri (H, W) int32)."""
    h, w = dirs.shape[:2]
    dimg, d = _strip_rays(dirs)
    origin = origins.reshape(-1, 3)[0]
    bins = BR.bin_scene(ds, pinhole_constants(ds, origin), origin, d, dimg)
    t, tri = BR.raycast_binned(bins, d, jnp.zeros((d.shape[0],), jnp.float32),
                               interpret=interpret)
    hp, wp = dimg.shape[:2]
    return (BR.strip_unorder(t, hp, wp)[:h, :w],
            BR.strip_unorder(tri, hp, wp)[:h, :w])


@functools.partial(jax.jit, static_argnums=0,
                   static_argnames=("chunk_size", "interpret"))
def render_frame(cfg: VCTConfig,
                 ds: DeviceScene,
                 voxels: VoxelState,
                 mats: MaterialTable,
                 origins: Array,             # (H, W, 3) camera rays
                 dirs: Array,                # (H, W, 3)
                 camera_position: Array,     # (3,)
                 light_dir: Optional[Array] = None,
                 chunk_size: int = 16384,
                 interpret: bool = False) -> Array:
    """Full camera pass -> (H, W, 3) linear RGB."""
    h, w = dirs.shape[:2]
    if light_dir is None:
        light_dir = light_direction(cfg)
    origin = origins.reshape(-1, 3)[0]
    dimg, d = _strip_rays(dirs)
    hp, wp = dimg.shape[:2]
    n = d.shape[0]

    pc = pinhole_constants(ds, origin)
    bins = BR.bin_scene(ds, pc, origin, d, dimg)

    def trace(tmin):
        return BR.raycast_binned(bins, d, tmin, interpret=interpret)

    t, tri = trace(jnp.zeros((n,), jnp.float32))
    t, tri = alpha_mask_recast(
        cfg, mats, lambda t_, i_: hits_to_gbuffer(ds, pc, origin, d, t_, i_),
        trace, t, tri)

    rgb = shade_hits(cfg, ds, pc, voxels, mats, origin, d, t, tri,
                     camera_position, light_dir, chunk_size)
    return BR.strip_unorder(rgb, hp, wp)[:h, :w]


def shade_hits(cfg: VCTConfig, ds: DeviceScene, pc, voxels: VoxelState,
               mats: MaterialTable, origin: Array, d: Array, t: Array,
               tri: Array, camera_position: Array, light_dir: Array,
               chunk_size: int = 16384) -> Array:
    """renderer.shade_gbuffer over (n, 3) same-origin rays and their
    closest hits (t (n,), +inf on a miss; tri (n,)), in chunks of
    chunk_size pixels -> (n, 3) linear RGB."""
    n = d.shape[0]
    chunk = min(chunk_size, n)
    pad = (-n) % chunk
    if pad:
        d = jnp.concatenate([d, jnp.broadcast_to(d[:1], (pad, 3))])
        t = jnp.concatenate([t, jnp.full((pad,), jnp.inf, t.dtype)])
        tri = jnp.concatenate([tri, jnp.zeros((pad,), tri.dtype)])

    def shade_chunk(args):
        dc, tc, ic = args
        g = hits_to_gbuffer(ds, pc, origin, dc, tc, ic)
        return shade_gbuffer(cfg, voxels, g, mats, camera_position,
                             light_dir)

    rgb = jax.lax.map(shade_chunk, (d.reshape(-1, chunk, 3),
                                    t.reshape(-1, chunk),
                                    tri.reshape(-1, chunk)))
    return rgb.reshape(-1, 3)[:n]

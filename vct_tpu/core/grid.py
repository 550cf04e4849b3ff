"""Voxel-grid math: world<->UVW mapping, (tri/quadri)linear sampling, mips.

This is the pure-jax.numpy oracle layer (SURVEY.md §7.2 step 1). Behavior is
pinned to the reference:

  * world -> UVW:  uvw = p / (world_size*0.5) * 0.5 + 0.5
    (Shader/VoxelConeTracing.fs:59-66 `SampleVoxels`)
  * sampling: GL_LINEAR_MIPMAP_LINEAR quadrilinear — trilinear within a level
    x linear between adjacent mip levels (Voxel_Cone_Tracing.h:112-113);
    texel centers at (i+0.5)/D, GL convention.
  * mip build: glGenerateMipmap's 2x2x2 box reduction
    (Voxel_Cone_Tracing.h:248).

Documented deviation: out-of-range coordinates clamp to the edge texel.  The
reference leaves the 3D texture at GL_REPEAT wrap (it never sets wrap modes),
which would wrap cone samples past the grid edge back into the scene — a
latent artifact, not a feature; grid edges are empty in practice.  Clamp is
the intended semantics and is what we test against.

Grids are arrays of shape (D, D, D, C) indexed [x, y, z, channel], C=4 RGBA.
A mip stack is a tuple of such arrays, level 0 finest.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


def world_to_uvw(p: Array, world_size: float) -> Array:
    """Map world position(s) (..., 3) to normalized texture coords in [0,1].

    Ref: VoxelConeTracing.fs:61-63.
    """
    return p / (world_size * 0.5) * 0.5 + 0.5


def uvw_to_world(uvw: Array, world_size: float) -> Array:
    return (uvw - 0.5) * world_size


def world_to_index(p: Array, world_size: float, dim: int) -> Array:
    """World position -> integer voxel index (..., 3), clamped to the grid."""
    uvw = world_to_uvw(p, world_size)
    idx = jnp.floor(uvw * dim).astype(jnp.int32)
    return jnp.clip(idx, 0, dim - 1)


def voxel_center(idx: Array, world_size: float, dim: int) -> Array:
    """Integer voxel index -> world-space center of that voxel."""
    uvw = (idx.astype(jnp.float32) + 0.5) / dim
    return uvw_to_world(uvw, world_size)


def trilinear_sample(grid: Array, uvw: Array) -> Array:
    """GL-convention trilinear sample of one level.

    grid: (D, D, D, C); uvw: (..., 3) in [0,1]. Returns (..., C).
    Texel centers at (i+0.5)/D; coordinates clamp to edge.
    """
    d = grid.shape[0]
    c = grid.shape[-1]
    t = uvw * d - 0.5
    i0 = jnp.floor(t)
    f = t - i0                                   # (..., 3) lerp weights
    i0 = i0.astype(jnp.int32)
    i1 = jnp.clip(i0 + 1, 0, d - 1)
    i0 = jnp.clip(i0, 0, d - 1)

    flat = grid.reshape(-1, c)

    def gather(ix, iy, iz):
        lin = (ix * d + iy) * d + iz
        return flat[lin]

    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx = f[..., 0:1]
    fy = f[..., 1:2]
    fz = f[..., 2:3]

    c000 = gather(x0, y0, z0)
    c001 = gather(x0, y0, z1)
    c010 = gather(x0, y1, z0)
    c011 = gather(x0, y1, z1)
    c100 = gather(x1, y0, z0)
    c101 = gather(x1, y0, z1)
    c110 = gather(x1, y1, z0)
    c111 = gather(x1, y1, z1)

    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def sample_lod(mips: Sequence[Array], uvw: Array, lod: float) -> Array:
    """Quadrilinear textureLod with a *static* lod (VoxelConeTracing.fs:65).

    The cone-march step schedule makes every lod a compile-time constant
    (core/march.py), so level selection costs nothing at runtime.
    """
    n = len(mips)
    lod = max(0.0, float(lod))
    l0 = min(int(lod), n - 1)
    l1 = min(l0 + 1, n - 1)
    w = lod - l0
    s0 = trilinear_sample(mips[l0], uvw)
    if w == 0.0 or l1 == l0:
        return s0
    s1 = trilinear_sample(mips[l1], uvw)
    return s0 * (1 - w) + s1 * w


def sample_voxels(mips: Sequence[Array], p_world: Array, lod: float,
                  world_size: float) -> Array:
    """SampleVoxels(worldPosition, lod) — VoxelConeTracing.fs:59-66."""
    return sample_lod(mips, world_to_uvw(p_world, world_size), lod)


def downsample2x(grid: Array, alpha_mode: str = "mean") -> Array:
    """One 2x2x2 reduction step (glGenerateMipmap level build).

    alpha_mode="mean": box filter all channels (GL behavior).
    alpha_mode="max":  box filter color, MAX the alpha channel —
      "conservative occupancy" mips: a coarse voxel is opaque if ANY child
      is.  Used for the shadow pyramid, where mean-reduction dilutes
      1-voxel-thick occluders (walls, ceilings) to near-transparency at the
      lods a long shadow cone samples, causing light leaks.
    """
    d = grid.shape[0]
    if d == 1:
        return grid
    # strided-slice formulation: slices keep the layout 4-D and fuse
    # cleanly, where a 7-D reshape(d/2,2,...) puts size-2 dims minor
    corners = [
        grid[ix::2, iy::2, iz::2]
        for ix in (0, 1) for iy in (0, 1) for iz in (0, 1)
    ]
    mean = sum(corners) * 0.125
    if alpha_mode == "mean":
        return mean
    if alpha_mode == "max":
        amax = corners[0][..., -1:]
        for c_ in corners[1:]:
            amax = jnp.maximum(amax, c_[..., -1:])
        return jnp.concatenate([mean[..., :-1], amax], axis=-1)
    raise ValueError(f"unknown alpha_mode {alpha_mode!r}")


def build_mips(grid: Array, num_levels: int | None = None,
               alpha_mode: str = "mean") -> Tuple[Array, ...]:
    """Full isotropic mip pyramid, level 0 = input (Voxel_Cone_Tracing.h:248)."""
    d = grid.shape[0]
    if d & (d - 1):
        raise ValueError(f"grid dim must be a power of two, got {d}")
    full = d.bit_length()                        # log2(d)+1 for power of two
    n = full if num_levels is None else min(num_levels, full)
    mips = [grid]
    for _ in range(n - 1):
        mips.append(downsample2x(mips[-1], alpha_mode))
    return tuple(mips)


def flatten_mips(mips: Sequence[Array]) -> Tuple[Array, Tuple[int, ...], Tuple[int, ...]]:
    """Pack a mip stack into one (V_total, C) array + per-level offsets/dims.

    Layout used by the Pallas kernels: one contiguous HBM buffer, static
    per-level row offsets (level dims are config constants).
    """
    c = mips[0].shape[-1]
    offsets = []
    dims = []
    off = 0
    for m in mips:
        offsets.append(off)
        dims.append(m.shape[0])
        off += m.shape[0] ** 3
    flat = jnp.concatenate([m.reshape(-1, c) for m in mips], axis=0)
    return flat, tuple(offsets), tuple(dims)


def unflatten_mips(flat: Array, offsets: Sequence[int], dims: Sequence[int]) -> Tuple[Array, ...]:
    c = flat.shape[-1]
    out = []
    for off, d in zip(offsets, dims):
        out.append(flat[off:off + d ** 3].reshape(d, d, d, c))
    return tuple(out)

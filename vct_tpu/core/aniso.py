"""Anisotropic (6-direction) voxel mip pyramid.

The reference acknowledges its isotropic mips as the missing piece
("should use anisotropic voxels / SVO", Voxel_Cone_Tracing.h:123-125) and
ships `glGenerateMipmap` box mips instead (Voxel_Cone_Tracing.h:248).  This
module builds the real thing: each mip level >= 1 stores SIX directional
pre-integrations of its children — for travel direction s, the 2x2x2 block
is composited front-to-back along the s axis (emission-absorption, exactly
the march's composite at `VoxelConeTracing.fs:100-102`) and box-averaged
over the 4 perpendicular child pairs.  A cone marching in direction d then
samples the directional levels blended by the squared direction components,
so thin occluders seen face-on stay opaque at coarse lods instead of being
diluted to alpha≈0.5 by the isotropic box filter.

Representation:
  level 0:      (D, D, D, C)      — isotropic, shared with the iso pyramid
  level l >= 1: (d, d, d, 6, C)   — direction-minor packing so ONE trilinear
                gather pulls all 6 directions as extra channels (one
                contiguous row per corner), and the per-direction blend is
                a single einsum over the 6-axis.
Direction order: (+x, -x, +y, -y, +z, -z).

Downsampling is the strided-slice formulation of core/grid.downsample2x;
each directional build is 8 slices + 4 composites + a mean, fused by XLA
into one pass over the level.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from vct_tpu.core import grid as G

Array = jax.Array

# direction order (+x, -x, +y, -y, +z, -z)
ANISO_DIRS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    np.float32)


def _composite_pair(near: Array, far: Array) -> Array:
    """Front-to-back emission-absorption of two samples along the travel
    direction: out = near + (1 - a_near) * far, for color AND alpha — the
    two-step closed form of the march composite (VoxelConeTracing.fs:100-102
    with the step folded into the voxel)."""
    return near + (1.0 - near[..., -1:]) * far


def _corner(level: Array, ox: int, oy: int, oz: int) -> Array:
    return level[ox::2, oy::2, oz::2]


def _downsample_directional(level: Array, axis: int, positive: bool) -> Array:
    """(d,d,d,...,C) -> (d/2,d/2,d/2,...,C): composite child pairs along
    `axis` (near = the face the cone enters first), box-average the 4
    perpendicular pairs."""
    near_off = 0 if positive else 1
    acc = None
    for p0 in (0, 1):
        for p1 in (0, 1):
            off = [p0, p1]
            off.insert(axis, near_off)
            near = _corner(level, *off)
            off[axis] = 1 - near_off
            far = _corner(level, *off)
            pair = _composite_pair(near, far)
            acc = pair if acc is None else acc + pair
    return acc * 0.25


def downsample_aniso_from_iso(level0: Array) -> Array:
    """Level 0 (D,D,D,C) -> level 1 (D/2,D/2,D/2,6,C)."""
    outs = [
        _downsample_directional(level0, axis, positive)
        for axis in (0, 1, 2) for positive in (True, False)
    ]
    # interleave to the (+x,-x,+y,-y,+z,-z) order: loop above already is
    return jnp.stack(outs, axis=-2)


def downsample_aniso(level: Array) -> Array:
    """Aniso level l (d,d,d,6,C) -> level l+1 (d/2,d/2,d/2,6,C).

    Direction s of the parent composites direction s of the children along
    s's axis — the per-direction pyramids are independent chains.
    """
    outs = []
    for s in range(6):
        axis, positive = divmod(s, 2)[0], s % 2 == 0
        outs.append(_downsample_directional(level[..., s, :], axis, positive))
    return jnp.stack(outs, axis=-2)


def build_aniso_mips(
    grid: Array, num_levels: Union[int, None] = None
) -> Tuple[Array, ...]:
    """Full anisotropic pyramid: (iso level0, aniso level1, aniso level2, …).

    Replaces glGenerateMipmap (Voxel_Cone_Tracing.h:248) when
    GridConfig.anisotropic is set (BASELINE.json config 2).
    """
    d = grid.shape[0]
    if d & (d - 1):
        raise ValueError(f"grid dim must be a power of two, got {d}")
    full = d.bit_length()
    n = full if num_levels is None else min(num_levels, full)
    mips = [grid]
    if n > 1:
        mips.append(downsample_aniso_from_iso(grid))
    for _ in range(n - 2):
        mips.append(downsample_aniso(mips[-1]))
    return tuple(mips)


def is_aniso_level(level: Array) -> bool:
    return level.ndim == 5


def is_aniso_stack(mips: Sequence[Array]) -> bool:
    return len(mips) > 1 and is_aniso_level(mips[1])


# ---------------------------------------------------------------------------
# direction weights
# ---------------------------------------------------------------------------

def aniso_weights(direction: Array) -> Array:
    """Blend weights (..., 6) over the directional levels for unit travel
    direction(s): w = d_i^2 on the matching sign, 0 on the opposite — a
    partition of unity (sum d_i^2 = 1)."""
    d2 = direction * direction
    pos = direction >= 0.0
    w = jnp.stack(
        [
            jnp.where(pos[..., 0], d2[..., 0], 0.0),
            jnp.where(pos[..., 0], 0.0, d2[..., 0]),
            jnp.where(pos[..., 1], d2[..., 1], 0.0),
            jnp.where(pos[..., 1], 0.0, d2[..., 1]),
            jnp.where(pos[..., 2], d2[..., 2], 0.0),
            jnp.where(pos[..., 2], 0.0, d2[..., 2]),
        ],
        axis=-1,
    )
    return w


def aniso_weights_static(direction) -> np.ndarray:
    """Static (6,) weights for a compile-time direction (dense passes)."""
    d = np.asarray(direction, np.float64)
    d = d / np.linalg.norm(d)
    w = np.zeros(6)
    for ax in range(3):
        w[2 * ax + (0 if d[ax] >= 0 else 1)] = d[ax] ** 2
    return w.astype(np.float32)


def blend_level_static(level: Array, w6) -> Array:
    """(d,d,d,6,C) x static (6,) -> (d,d,d,C) isotropic view for one fixed
    direction (used by the dense direction-major marches)."""
    w = jnp.asarray(w6, level.dtype)
    return jnp.einsum("xyzsc,s->xyzc", level, w)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def sample_aniso_level(level: Array, uvw: Array, direction: Array) -> Array:
    """Trilinear sample of one directional level with traced directions.

    level (d,d,d,6,C); uvw (...,3); direction (...,3) unit. One gather of
    6C channels + a 6-way weighted sum. Returns (..., C).
    """
    d = level.shape[0]
    six_c = level.shape[-2] * level.shape[-1]
    c = level.shape[-1]
    packed = level.reshape(d, d, d, six_c)
    s = G.trilinear_sample(packed, uvw)
    s = s.reshape(s.shape[:-1] + (6, c))
    w = aniso_weights(direction)
    return jnp.einsum("...s,...sc->...c", w, s)


def sample_schedule_aniso(
    mips: Sequence[Array],
    points: Array,                 # (..., K, 3) world positions
    lods: Sequence[float],
    world_size: float,
    direction: Array,              # (..., 3) unit travel direction
) -> Array:
    """Aniso-stack analogue of core/march.sample_schedule: quadrilinear taps
    for all K steps with static lods; level 0 samples isotropically, levels
    >= 1 blend the 6 directional grids by aniso_weights(direction)."""
    from vct_tpu.core import march as M

    k = points.shape[-2]
    assert k == len(lods)
    plan = M._static_lod_plan(lods, len(mips))
    uvw = G.world_to_uvw(points, world_size)
    dir_b = jnp.broadcast_to(direction[..., None, :], points.shape)

    need = {}
    for step, (l0, l1, w) in enumerate(plan):
        need.setdefault(l0, []).append(step)
        if w > 0.0 and l1 != l0:
            need.setdefault(l1, []).append(step)

    per_level = {}
    for lvl, steps in need.items():
        pts = uvw[..., np.array(steps), :]
        if is_aniso_level(mips[lvl]):
            res = sample_aniso_level(
                mips[lvl], pts, dir_b[..., np.array(steps), :])
        else:
            res = G.trilinear_sample(mips[lvl], pts)
        per_level[lvl] = {s: res[..., i, :] for i, s in enumerate(steps)}

    out = []
    for step, (l0, l1, w) in enumerate(plan):
        s0 = per_level[l0][step]
        if w > 0.0 and l1 != l0:
            out.append(s0 * (1.0 - w) + per_level[l1][step] * w)
        else:
            out.append(s0)
    return jnp.stack(out, axis=-2)

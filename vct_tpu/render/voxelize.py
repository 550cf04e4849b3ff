"""Deterministic, differentiable scene voxelization.

Replaces the reference's GS dominant-axis rasterization + unordered
last-write-wins imageStore (Shader/Voxelization.{vs,gs,fs}; SURVEY.md §2.2
K2-K4) with a two-stage array program:

  host (numpy, once per scene):  stratified surface point samples per
  triangle at a density of `samples_per_voxel_width` samples per voxel edge
  — the analogue of rasterizing each triangle along its dominant axis at
  voxel resolution (Voxelization.gs:29-49), but axis-free and deterministic.

  device (jax, differentiable):  scatter-ADD sample radiance and coverage
  counts into the grid with segment_sum, then normalize — scatter-mean
  instead of the reference's benign race (Voxelization.fs:88, last fragment
  wins).  Gradients flow to per-sample radiance (hence albedo, textures,
  light) out of the box; the sample positions are static geometry.

Voxel alpha is binary occupancy (count > 0), matching vec4(.., 1.0) at
Voxelization.fs:88.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vct_tpu.scene.mesh import Scene

Array = jax.Array


@dataclasses.dataclass
class SurfaceSamples:
    """Static point-sampling of scene surfaces (host-side prep output)."""

    positions: np.ndarray      # (S, 3) world space
    normals: np.ndarray        # (S, 3) face normals
    uvs: np.ndarray            # (S, 2)
    material_ids: np.ndarray   # (S,) int32
    tri_ids: np.ndarray        # (S,) int32

    @property
    def count(self) -> int:
        return int(self.positions.shape[0])


def generate_surface_samples(
    scene: Scene,
    voxel_world_size: float,
    samples_per_voxel_width: float = 2.0,
    max_samples_per_tri: int = 4096,
    backend: str = "auto",
) -> SurfaceSamples:
    """Stratified barycentric samples, ~density^2 per voxel-sized patch.

    Per triangle the subdivision n is chosen so sample spacing is at most
    voxel_size/density along the longest edge, guaranteeing every voxel a
    triangle crosses receives samples (the coverage property the dominant-
    axis rasterization provides in the reference).

    backend="auto" uses the native C++ generator (vct_tpu/native) when the
    library is available — identical float math, triangle-major sample
    order (the numpy path batches triangles by subdivision level; the
    sample multiset is equal and splat() is order-independent).
    "python" forces the numpy path.
    """
    tv = scene.triangle_vertices()                    # (T, 3, 3)
    fn = scene.face_normals()
    t_uv = scene.uvs[scene.indices]                   # (T, 3, 2)

    if backend == "auto":
        from vct_tpu import native
        got = native.surface_samples(
            tv, t_uv, fn, scene.tri_material, voxel_world_size,
            samples_per_voxel_width, max_samples_per_tri)
        if got is not None:
            pos, nrm, uv, mat, tri = got
            return SurfaceSamples(positions=pos, normals=nrm, uvs=uv,
                                  material_ids=mat, tri_ids=tri)

    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    e3 = tv[:, 2] - tv[:, 1]
    longest = np.maximum(np.maximum(
        np.linalg.norm(e1, axis=-1), np.linalg.norm(e2, axis=-1)),
        np.linalg.norm(e3, axis=-1))
    n_per_tri = np.ceil(longest / voxel_world_size * samples_per_voxel_width)
    n_per_tri = np.clip(n_per_tri, 1,
                        int(np.sqrt(max_samples_per_tri))).astype(np.int64)

    pos_out, nrm_out, uv_out, mat_out, tri_out = [], [], [], [], []
    # group triangles by subdivision level so the inner work is vectorized
    for n in np.unique(n_per_tri):
        sel = np.nonzero(n_per_tri == n)[0]
        # barycentric lattice: cells (i, j), i+j < n, upper+lower triangles
        ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        keep_lo = (ii + jj) <= n - 1
        u_lo = (ii[keep_lo] + 1.0 / 3.0) / n
        v_lo = (jj[keep_lo] + 1.0 / 3.0) / n
        keep_hi = (ii + jj) <= n - 2
        u_hi = (ii[keep_hi] + 2.0 / 3.0) / n
        v_hi = (jj[keep_hi] + 2.0 / 3.0) / n
        u = np.concatenate([u_lo, u_hi]).astype(np.float32)   # (P,)
        v = np.concatenate([v_lo, v_hi]).astype(np.float32)
        w0 = 1.0 - u - v
        p = (w0[None, :, None] * tv[sel, None, 0]
             + u[None, :, None] * tv[sel, None, 1]
             + v[None, :, None] * tv[sel, None, 2])            # (B, P, 3)
        uvs = (w0[None, :, None] * t_uv[sel, None, 0]
               + u[None, :, None] * t_uv[sel, None, 1]
               + v[None, :, None] * t_uv[sel, None, 2])        # (B, P, 2)
        b, pcount = p.shape[0], p.shape[1]
        pos_out.append(p.reshape(-1, 3))
        uv_out.append(uvs.reshape(-1, 2))
        nrm_out.append(np.repeat(fn[sel], pcount, axis=0))
        mat_out.append(np.repeat(scene.tri_material[sel], pcount))
        tri_out.append(np.repeat(sel.astype(np.int32), pcount))

    return SurfaceSamples(
        positions=np.concatenate(pos_out).astype(np.float32),
        normals=np.concatenate(nrm_out).astype(np.float32),
        uvs=np.concatenate(uv_out).astype(np.float32),
        material_ids=np.concatenate(mat_out).astype(np.int32),
        tri_ids=np.concatenate(tri_out).astype(np.int32),
    )


def splat(
    positions: Array,          # (S, 3) world
    values: Array,             # (S, C) per-sample radiance/albedo
    weights: Array,            # (S,) sample weights (0 drops a sample)
    dim: int,
    world_size: float,
    mode: str = "mean",
) -> Array:
    """Scatter samples into a (dim, dim, dim, C+1) grid; alpha = occupancy.

    mode="mean": color = sum(w*value)/sum(w) — deterministic replacement for
    the reference's last-write-wins (Voxelization.fs:88).
    mode="max":  color = per-channel max (useful for emissive debug).
    Differentiable w.r.t. `values` (and `weights`).
    """
    uvw = positions / (world_size * 0.5) * 0.5 + 0.5
    idx = jnp.floor(uvw * dim).astype(jnp.int32)
    inside = jnp.all((idx >= 0) & (idx < dim), axis=-1)
    idx = jnp.clip(idx, 0, dim - 1)
    flat = (idx[:, 0] * dim + idx[:, 1]) * dim + idx[:, 2]
    w = jnp.where(inside, weights, 0.0)
    n = dim ** 3
    c = values.shape[-1]
    # one 1-D scatter per channel into an (n,) target; the channels are
    # independent, so C scatters do the work of one (n, C) scatter
    if mode == "mean":
        wsum = jnp.zeros((n,), values.dtype).at[flat].add(w)
        cols = [jnp.zeros((n,), values.dtype).at[flat].add(w * values[:, j])
                for j in range(c)]
        vsum = jnp.stack(cols, axis=-1)
        color = vsum / jnp.maximum(wsum[:, None], 1e-8)
        alpha = (wsum > 0).astype(values.dtype)
    elif mode == "max":
        cols = [jnp.zeros((n,), values.dtype).at[flat].max(
            jnp.where(w > 0, values[:, j], 0.0)) for j in range(c)]
        color = jnp.stack(cols, axis=-1)
        alpha = (jnp.zeros((n,), values.dtype).at[flat].add(w) > 0
                 ).astype(values.dtype)
    else:
        raise ValueError(f"unknown splat mode {mode!r}")
    out = jnp.concatenate([color, alpha[:, None]], axis=-1)
    return out.reshape(dim, dim, dim, c + 1)

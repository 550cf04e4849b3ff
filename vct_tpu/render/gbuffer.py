"""Primary visibility: ray-cast G-buffer.

Replaces the hardware rasterizer + VoxelConeTracing.vs interpolants
(SURVEY.md §7.1): per-pixel rays intersect the triangle soup and the hit's
barycentrics interpolate exactly the attributes the reference's vertex
shader hands the fragment stage (Position_world, Normal_world,
Tangent_world, BiTangent_world, tex; VoxelConeTracing.vs:25-36).

Two paths:
  * general Möller–Trumbore over all triangles (any origins), chunked
    over rays via lax.map;
  * a pinhole path for camera rays (one shared origin): with o fixed,
    the triple products det = d.(e2 x e1), u*det = d.(e2 x tvec),
    v*det = d.(tvec x e1) are LINEAR in the ray direction, so the whole
    intersection test becomes three (N,3)x(3,T) contractions plus a fused
    select+argmin — no per-ray cross products, no (N,T,3)
    intermediates.  t*det = e2.(tvec x e1) is ray-independent entirely.

Both are brute force (every ray against every triangle) and serve as the
oracle of the binned camera-pass raycast (ops/binrast_pallas.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vct_tpu.scene.mesh import Scene

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GBuffer:
    """Per-pixel surface attributes; invalid where ~hit."""

    hit: Array            # (..., ) bool
    t: Array              # (..., ) ray parameter
    position: Array       # (..., 3) world
    normal: Array         # (..., 3) shading normal (vertex-interpolated)
    geo_normal: Array     # (..., 3) face normal
    tangent: Array        # (..., 3)
    bitangent: Array      # (..., 3)
    uv: Array             # (..., 2)
    material: Array       # (..., ) int32
    tri: Array            # (..., ) int32


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DeviceScene:
    """Scene geometry as device arrays (the renderer's working set).

    Registered as a pytree so it can be passed as a jit argument instead
    of being embedded as a constant in every compiled program.
    """

    v0: Array            # (T, 3)
    e1: Array            # (T, 3)
    e2: Array            # (T, 3)
    vn: Array            # (T, 3, 3) per-corner normals
    vt: Array            # (T, 3, 3) tangents
    vb: Array            # (T, 3, 3) bitangents
    vuv: Array           # (T, 3, 2)
    face_normal: Array   # (T, 3)
    material: Array      # (T,) int32

    @staticmethod
    def from_scene(scene: Scene, dtype=jnp.float32,
                   morton_sort: bool = True) -> "DeviceScene":
        tv = scene.triangle_vertices()
        idx = scene.indices
        order = slice(None)
        if morton_sort:
            # spatially-compact triangle order: neighbouring triangles
            # land in neighbouring table rows
            order = _morton_order(tv.mean(axis=1))
        return DeviceScene(
            v0=jnp.asarray(tv[order, 0], dtype),
            e1=jnp.asarray(tv[order, 1] - tv[order, 0], dtype),
            e2=jnp.asarray(tv[order, 2] - tv[order, 0], dtype),
            vn=jnp.asarray(scene.normals[idx][order], dtype),
            vt=jnp.asarray(scene.tangents[idx][order], dtype),
            vb=jnp.asarray(scene.bitangents[idx][order], dtype),
            vuv=jnp.asarray(scene.uvs[idx][order], dtype),
            face_normal=jnp.asarray(scene.face_normals()[order], dtype),
            material=jnp.asarray(scene.tri_material[order], jnp.int32),
        )


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Stable argsort of 30-bit 3D Morton codes of the centroids."""
    c = np.asarray(centroids, np.float64)
    lo = c.min(axis=0)
    ext = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip((c - lo) / ext * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = ((spread(q[:, 0]) << np.uint64(2))
            | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2]))
    return np.argsort(code, kind="stable")


def _intersect_chunk(origins: Array, dirs: Array, ds: DeviceScene,
                     eps: float = 1e-7) -> Tuple[Array, Array, Array, Array]:
    """Möller–Trumbore, all rays x all triangles.

    origins/dirs: (N, 3). Returns (t, u, v, tri_idx) with t=inf for miss.
    """
    pvec = jnp.cross(dirs[:, None, :], ds.e2[None, :, :])       # (N, T, 3)
    det = jnp.sum(pvec * ds.e1[None], axis=-1)                   # (N, T)
    inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
    tvec = origins[:, None, :] - ds.v0[None]
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, ds.e1[None, :, :])
    v = jnp.sum(dirs[:, None, :] * qvec, axis=-1) * inv_det
    t = jnp.sum(ds.e2[None] * qvec, axis=-1) * inv_det
    valid = ((jnp.abs(det) > eps) & (u >= 0) & (v >= 0) & (u + v <= 1)
             & (t > 1e-4))
    t = jnp.where(valid, t, jnp.inf)
    tri = jnp.argmin(t, axis=-1)                                 # (N,)
    n = origins.shape[0]
    rows = jnp.arange(n)
    return t[rows, tri], u[rows, tri], v[rows, tri], tri


def raycast_chunk(ds: DeviceScene, o: Array, d: Array) -> GBuffer:
    """Closest-hit G-buffer for one flat chunk of rays (N, 3)."""
    t, u, v, tri = _intersect_chunk(o, d, ds)
    return _interp_gbuffer(ds, o, d, t, u, v, tri)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PinholeConstants:
    """Per-triangle constants for a fixed ray origin (see module doc)."""

    a: Array       # (T, 3)  det    = d . a,  a = e2 x e1
    b: Array       # (T, 3)  u*det  = d . b,  b = e2 x tvec
    c: Array       # (T, 3)  v*det  = d . c,  c = tvec x e1
    k: Array       # (T,)    t*det  = e2 . c


def pinhole_constants(ds: DeviceScene, origin: Array) -> PinholeConstants:
    """O(T) prep folding the shared origin into the triangle data."""
    tvec = origin[None, :] - ds.v0
    c = jnp.cross(tvec, ds.e1)
    return PinholeConstants(
        a=jnp.cross(ds.e2, ds.e1),
        b=jnp.cross(ds.e2, tvec),
        c=c,
        k=jnp.sum(ds.e2 * c, axis=-1),
    )


def intersect_chunk_pinhole(dirs: Array, pc: PinholeConstants,
                             eps: float = 1e-7,
                             tmin: Optional[Array] = None,
                             ) -> Tuple[Array, Array, Array]:
    """Closest hit for one chunk of same-origin rays: three K=3
    contractions + a sign-folded validity mask + argmin.  Returns
    (t, tri).

    tmin: optional per-ray (N,) minimum hit distance — the alpha-mask
    re-cast continues a ray past a masked hit (fs:169-172 `discard`
    exposes the surface behind; see renderer.render_rays).

    The contractions are exact-f32 multiply-adds, the same expression the
    binned kernel evaluates: u*det and v*det are small differences of
    much larger products, so a TF32 or bf16 matmul flips `valid` for
    thin or grazing triangles."""
    def dot3(b):                                                 # (N, T)
        return (dirs[:, 0:1] * b[None, :, 0] + dirs[:, 1:2] * b[None, :, 1]
                + dirs[:, 2:3] * b[None, :, 2])

    det = dot3(pc.a)
    ud = dot3(pc.b)
    vd = dot3(pc.c)
    s = jnp.sign(det)
    ad = jnp.abs(det)
    # u,v,t conditions multiplied through by |det| (sign-safe):
    valid = ((ad > eps) & (s * ud >= 0) & (s * vd >= 0)
             & (s * (ud + vd) <= ad) & (s * pc.k[None, :] > 1e-4 * ad))
    tval = (s * pc.k[None, :]) / jnp.maximum(ad, eps)
    if tmin is not None:
        valid = valid & (tval > tmin[:, None])
    t = jnp.where(valid, tval, jnp.inf)
    tri = jnp.argmin(t, axis=-1)
    return jnp.min(t, axis=-1), tri


def raycast_chunk_pinhole(ds: DeviceScene, pc: PinholeConstants,
                          origin: Array, d: Array,
                          tmin: Optional[Array] = None) -> GBuffer:
    """raycast_chunk for same-origin rays (primary camera rays)."""
    t, tri = intersect_chunk_pinhole(d, pc, tmin=tmin)
    return hits_to_gbuffer(ds, pc, origin, d, t, tri)


def pinhole_hits(ds: DeviceScene, origin: Array, d: Array,
                 chunk_size: int = 1024) -> Tuple[Array, Array]:
    """Brute-force closest hits (t (n,), +inf on a miss; tri (n,)) of
    same-origin rays d (n, 3), chunked so each (chunk x triangles) array
    stays bounded — the oracle the binned raycast is compared with."""
    n = d.shape[0]
    pad = (-n) % chunk_size
    dp = jnp.concatenate([d, jnp.broadcast_to(d[:1], (pad, 3))])
    pc = pinhole_constants(ds, origin)
    t, tri = jax.lax.map(lambda dc: intersect_chunk_pinhole(dc, pc),
                         dp.reshape(-1, chunk_size, 3))
    return t.reshape(-1)[:n], tri.reshape(-1)[:n]


def hits_to_gbuffer(ds: DeviceScene, pc: PinholeConstants, origin: Array,
                    d: Array, t: Array, tri: Array) -> GBuffer:
    """G-buffer of same-origin rays (N, 3) from their closest hits
    (t (N,), +inf on a miss; tri (N,)).  The winner's barycentrics are
    recomputed exactly against just its triangle (3 dots per ray)."""
    det = jnp.sum(d * pc.a[tri], axis=-1)
    inv = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    u = jnp.sum(d * pc.b[tri], axis=-1) * inv
    v = jnp.sum(d * pc.c[tri], axis=-1) * inv
    o = jnp.broadcast_to(origin[None, :], d.shape)
    return _interp_gbuffer(ds, o, d, t, u, v, tri)


def raycast(ds: DeviceScene, origins: Array, dirs: Array,
            chunk_size: int = 4096) -> GBuffer:
    """Closest-hit G-buffer for rays of any batch shape (..., 3)."""
    shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    n = o.shape[0]
    pad = (-n) % chunk_size
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
        d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)])

    def chunk_fn(args):
        return _intersect_chunk(args[0], args[1], ds)

    t, u, v, tri = jax.lax.map(
        chunk_fn,
        (o.reshape(-1, chunk_size, 3), d.reshape(-1, chunk_size, 3)))
    t, u, v, tri = (x.reshape(-1)[:n] for x in (t, u, v, tri))
    o, d = o[:n], d[:n]
    g = _interp_gbuffer(ds, o, d, t, u, v, tri)

    def reshape(x):
        return x.reshape(shape + x.shape[1:])

    return jax.tree_util.tree_map(reshape, g)


def _interp_gbuffer(ds: DeviceScene, o: Array, d: Array, t: Array,
                    u: Array, v: Array, tri: Array) -> GBuffer:
    hit = jnp.isfinite(t)
    ts = jnp.where(hit, t, 0.0)
    w0 = (1.0 - u - v)[:, None]
    uu, vv = u[:, None], v[:, None]

    def interp(attr):   # (T, 3, C) -> (N, C)
        a = attr[tri]
        return w0 * a[:, 0] + uu * a[:, 1] + vv * a[:, 2]

    normal = interp(ds.vn)
    normal = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-12)

    return GBuffer(
        hit=hit,
        t=ts,
        position=o + ts[:, None] * d,
        normal=normal,
        geo_normal=ds.face_normal[tri],
        tangent=interp(ds.vt),
        bitangent=interp(ds.vb),
        uv=interp(ds.vuv),
        material=ds.material[tri],
        tri=tri.astype(jnp.int32),
    )

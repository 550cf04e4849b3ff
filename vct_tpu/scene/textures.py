"""Material textures: per-material atlas + bilinear sampling + bump normals.

Replaces the reference's GL texture units (Mesh.h:89-111 binds
DiffuseTexture / SpecularTexture / HeightTexture / MaskTexture per mesh;
Model.h:141-186 uploads stb_image data with mipmaps).  Design:

  * ONE atlas array per slot of shape (M, R, R, C) — every material's
    texture resampled to a common static resolution R.  Static shapes, and
    a texture fetch is a single gather indexed by (material, y, x), batched
    over all pixels at once.  Materials without a texture get their
    constant color broadcast into their atlas page, so sampling is
    branch-free (matches an unbound GL sampler falling back to the
    material constant, the Material docstring contract).
  * Wrap mode REPEAT (GL default, what the reference's material textures
    use) via floating-point mod before the bilinear footprint.
  * Bump normals follow CalcBumpNormal (VoxelConeTracing.fs:108-126):
    forward-difference the height texture by one texel, build
    t1=(1,0,dx), t2=(0,1,dy), normal = normalize(cross(t1,t2)), rotate by
    the TBN frame.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vct_tpu.scene.mesh import Material

Array = jax.Array


def _resize_bilinear_np(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Host-side bilinear resize (H, W, C) -> (h, w, C); align-corners=False
    (GL texel-center convention)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return img.astype(np.float32)
    ys = (np.arange(oh) + 0.5) * (h / oh) - 0.5
    xs = (np.arange(ow) + 0.5) * (w / ow) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0][:, x0] * (1 - fy) * (1 - fx) + img[y0][:, x1] * (1 - fy) * fx
    b = img[y1][:, x0] * fy * (1 - fx) + img[y1][:, x1] * fy * fx
    return (a + b).astype(np.float32)


def _page(tex: Optional[np.ndarray], const: Sequence[float], res: int,
          channels: int) -> np.ndarray:
    """One material's atlas page: resampled texture or constant fill."""
    if tex is None:
        page = np.empty((res, res, channels), np.float32)
        page[:] = np.asarray(const, np.float32)[:channels]
        return page
    t = np.asarray(tex, np.float32)
    if t.ndim == 2:
        t = t[..., None]
    if t.shape[-1] < channels:       # e.g. RGB diffuse -> RGBA alpha=1
        pad = np.ones(t.shape[:-1] + (channels - t.shape[-1],), np.float32)
        t = np.concatenate([t, pad], axis=-1)
    return _resize_bilinear_np(t[..., :channels], (res, res))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TextureAtlas:
    """Per-material texture pages on device.

    albedo (M,R,R,4) rgba; specular (M,R,R,3); height (M,R,R,1).
    `resolution` rides along for the bump-offset (HeightTextureSize
    uniform, VoxelConeTracing.fs:16,110).
    """

    albedo: Array
    specular: Array
    height: Array

    @property
    def resolution(self) -> int:
        return self.albedo.shape[1]

    @staticmethod
    def from_materials(materials: List[Material],
                       resolution: int = 256) -> "TextureAtlas":
        alb, spec, hgt = [], [], []
        for m in materials:
            a = _page(m.albedo_texture, m.albedo, resolution, 4)
            if m.mask_texture is not None:
                # MaskTexture folds into diffuse alpha: the discard test
                # reads matColor.a (VoxelConeTracing.fs:169-172)
                a[..., 3] = _page(m.mask_texture, (1.0,), resolution, 1)[..., 0]
            elif m.albedo_texture is not None and \
                    np.asarray(m.albedo_texture).shape[-1] < 4:
                a[..., 3] = m.albedo[3]
            alb.append(a)
            spec.append(_page(m.specular_texture, m.specular, resolution, 3))
            hgt.append(_page(m.height_texture, (0.0,), resolution, 1))
        return TextureAtlas(
            albedo=jnp.asarray(np.stack(alb)),
            specular=jnp.asarray(np.stack(spec)),
            height=jnp.asarray(np.stack(hgt)),
        )


def has_textures(materials: List[Material]) -> bool:
    return any(
        m.albedo_texture is not None or m.specular_texture is not None
        or m.height_texture is not None or m.mask_texture is not None
        for m in materials)


def sample_atlas(atlas_pages: Array, material_id: Array, uv: Array) -> Array:
    """Bilinear REPEAT-wrapped fetch: pages (M,R,R,C), material_id (...,),
    uv (...,2) -> (...,C).  GL convention: texel centers at (i+0.5)/R,
    v=0 at the bottom row (images are stored top-down, so v flips)."""
    m, rh, rw, c = atlas_pages.shape
    u = uv[..., 0] * rw - 0.5
    v = (1.0 - uv[..., 1]) * rh - 0.5
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0 = u0.astype(jnp.int32)
    v0 = v0.astype(jnp.int32)
    u1 = jnp.remainder(u0 + 1, rw)
    v1 = jnp.remainder(v0 + 1, rh)
    u0 = jnp.remainder(u0, rw)
    v0 = jnp.remainder(v0, rh)

    flat = atlas_pages.reshape(-1, c)
    base = material_id * (rh * rw)

    def fetch(vy, ux):
        return flat[base + vy * rw + ux]

    t00 = fetch(v0, u0)
    t01 = fetch(v0, u1)
    t10 = fetch(v1, u0)
    t11 = fetch(v1, u1)
    top = t00 * (1 - fu) + t01 * fu
    bot = t10 * (1 - fu) + t11 * fu
    return top * (1 - fv) + bot * fv


def bump_normal(atlas: TextureAtlas, material_id: Array, uv: Array,
                tangent: Array, bitangent: Array, normal: Array) -> Array:
    """CalcBumpNormal (VoxelConeTracing.fs:108-126): forward-difference the
    height page by one texel, tangent-space normal = normalize(cross(
    normalize(1,0,dx), normalize(0,1,dy))), rotated into world by TBN."""
    res = atlas.resolution
    off = 1.0 / res
    h0 = sample_atlas(atlas.height, material_id, uv)[..., 0]
    hx = sample_atlas(atlas.height, material_id,
                      uv + jnp.asarray([off, 0.0], uv.dtype))[..., 0]
    hy = sample_atlas(atlas.height, material_id,
                      uv + jnp.asarray([0.0, off], uv.dtype))[..., 0]
    dx = hx - h0
    dy = hy - h0
    one = jnp.ones_like(dx)
    zero = jnp.zeros_like(dx)
    t1 = _norm3(jnp.stack([one, zero, dx], axis=-1))
    t2 = _norm3(jnp.stack([zero, one, dy], axis=-1))
    bn = _norm3(jnp.cross(t1, t2))
    world = (tangent * bn[..., 0:1] + bitangent * bn[..., 1:2]
             + normal * bn[..., 2:3])
    return _norm3(world)


def _norm3(v: Array) -> Array:
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


# ---------------------------------------------------------------------------
# corner-packed atlas: ONE gather row per pixel for albedo + specular + the
# full bump-normal height neighborhood.  XLA gathers are row-bound (~50M
# rows/s regardless of width, scripts/bench_gather.py), so the win is
# collapsing the 20 rows/pixel of sample_atlas + bump_normal into 1.
# ---------------------------------------------------------------------------

PACKED_CH = 40   # 4 corners x (albedo4 + spec3) = 28, height 3x3 = 9, pad 40


def pack_atlas(atlas: TextureAtlas) -> Array:
    """(M, R, R, PACKED_CH): texel (v, u) holds its 2x2 bilinear footprint
    of [albedo|specular] (corners (dv,du) in row-major order) plus the 3x3
    height neighborhood rows (v-1, v, v+1) x cols (u, u+1, u+2) needed by
    the three bump taps (h0/hx/hy, VoxelConeTracing.fs:110-126).  REPEAT
    wrap baked in via jnp.roll."""
    color = jnp.concatenate([atlas.albedo, atlas.specular], axis=-1)  # 7ch
    parts = []
    for dv in (0, 1):
        for du in (0, 1):
            parts.append(jnp.roll(color, (-dv, -du), axis=(1, 2)))
    h = atlas.height
    for dv in (-1, 0, 1):
        for du in (0, 1, 2):
            parts.append(jnp.roll(h, (-dv, -du), axis=(1, 2)))
    packed = jnp.concatenate(parts, axis=-1)                          # 37ch
    m, rh, rw, c = packed.shape
    return jnp.concatenate(
        [packed, jnp.zeros((m, rh, rw, PACKED_CH - c), packed.dtype)],
        axis=-1)


def sample_packed(packed: Array, resolution: int, material_id: Array,
                  uv: Array):
    """One packed-row fetch -> (albedo4, specular3, (h0, hx, hy)).

    Matches sample_atlas's bilinear REPEAT fetch and bump_normal's three
    height taps exactly (same texel footprints, same weights).
    """
    rh = rw = resolution
    u = uv[..., 0] * rw - 0.5
    v = (1.0 - uv[..., 1]) * rh - 0.5
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    u0 = jnp.remainder(u0.astype(jnp.int32), rw)
    v0 = jnp.remainder(v0.astype(jnp.int32), rh)

    flat = packed.reshape(-1, packed.shape[-1])
    row = flat[material_id * (rh * rw) + v0 * rw + u0]    # (..., PACKED_CH)

    def bilerp(c00, c01, c10, c11):
        top = c00 * (1 - fu) + c01 * fu
        bot = c10 * (1 - fu) + c11 * fu
        return top * (1 - fv) + bot * fv

    c = [row[..., i * 7:(i + 1) * 7] for i in range(4)]   # (dv,du) corners
    color = bilerp(c[0], c[1], c[2], c[3])
    albedo, spec = color[..., :4], color[..., 4:7]

    # height grid rows (v-1, v, v+1) x cols (u, u+1, u+2), row-major
    hg = [row[..., 28 + i:29 + i] for i in range(9)]
    h0 = bilerp(hg[3], hg[4], hg[6], hg[7])               # rows v,v+1 cols u,u+1
    hx = bilerp(hg[4], hg[5], hg[7], hg[8])               # cols u+1,u+2
    hy = bilerp(hg[0], hg[1], hg[3], hg[4])               # rows v-1,v
    return albedo, spec, (h0[..., 0], hx[..., 0], hy[..., 0])


def bump_normal_from_heights(h0: Array, hx: Array, hy: Array, tangent: Array,
                             bitangent: Array, normal: Array) -> Array:
    """bump_normal's tangent-frame math given the three height taps."""
    dx = hx - h0
    dy = hy - h0
    one = jnp.ones_like(dx)
    zero = jnp.zeros_like(dx)
    t1 = _norm3(jnp.stack([one, zero, dx], axis=-1))
    t2 = _norm3(jnp.stack([zero, one, dy], axis=-1))
    bn = _norm3(jnp.cross(t1, t2))
    world = (tangent * bn[..., 0:1] + bitangent * bn[..., 1:2]
             + normal * bn[..., 2:3])
    return _norm3(world)

"""Direction-major (grid-major) dense cone marching.

The reference marches cones per fragment (VoxelConeTracing.fs:82-107):
per-pixel gathers at arbitrary positions.  For the products every pixel
shares (the light volume, the basis cone fields) this module restructures
the march to be GRID-major: march a cone *from every voxel center
simultaneously* along a FIXED direction.  Then every step reads the mip
level at (voxel_center + dist_k * dir) — a constant world offset — a
*separable shifted-trilinear resample*: three axis gathers of whole slices
(contiguous, bandwidth-speed) + lerps.  Zero per-element gathers.

Products:
  * light transmittance volume  S(v) = shadow cone from every voxel toward
    the light (one direction) — replaces both the reference's shadow map
    (4096^2 depth pass, Voxel_Cone_Tracing.h:81-105) and per-pixel/per-
    sample shadow marches with a single dense pass + one tap per query.
  * cone-gather fields G_b(v) = Voxel_Cone_Tracing(v, dir_b, tan) for a
    basis of world directions b — per-pixel indirect diffuse becomes a
    spherical interpolation of a few G fields at one position.

Both are EXACT cone marches at voxel centers (same schedule/composite as
core/march.py); between centers queries are trilinear, the same
interpolation the reference's hardware sampler applies to its textures.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vct_tpu.core import march as M

Array = jax.Array


def _axis_indices(df: int, dl: int, shift_vox_l: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """1D sample prep for one axis: field row i (at field res df) sampling a
    level of size dl shifted by shift_vox_l (in level-voxel units).

    Field voxel center i maps to level coordinate
      t = (i + 0.5) * (dl / df) + shift_vox_l - 0.5
    Returns (i0, i1, frac) with clamp-to-edge, all length df.
    """
    t = (np.arange(df) + 0.5) * (dl / df) + shift_vox_l - 0.5
    i0 = np.floor(t)
    f = (t - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    i1 = np.clip(i0 + 1, 0, dl - 1)
    i0c = np.clip(i0, 0, dl - 1)
    # preserve exact-zero weights at clamped edges so content doesn't smear
    return i0c.astype(np.int32), i1.astype(np.int32), f


def sample_shifted(level: Array, df: int, shift_vox: Sequence[float]) -> Array:
    """Resample `level` (dl,dl,dl,C) at the df^3 field grid shifted by a
    constant offset (in level-voxel units). Separable: one slice-gather +
    lerp per axis (contiguous accesses; no arbitrary gathers)."""
    dl = level.shape[0]
    out = level
    for axis, sv in enumerate(shift_vox):
        i0, i1, f = _axis_indices(df, dl, float(sv))
        a = jnp.take(out, jnp.asarray(i0), axis=axis)
        b = jnp.take(out, jnp.asarray(i1), axis=axis)
        shape = [1, 1, 1, 1]
        shape[axis] = df
        w = jnp.asarray(f).reshape(shape)
        out = a * (1.0 - w) + b * w
    return out


def _interp_matrix(i0: Array, i1: Array, f: Array, dl: int,
                   dtype=None) -> Array:
    """(df, dl) interpolation matrix W with W[r, i0[r]] += 1-f[r],
    W[r, i1[r]] += f[r] — so W @ axis does take+lerp in one matmul."""
    cols = jax.lax.broadcasted_iota(jnp.int32, (i0.shape[0], dl), 1)
    w0 = jnp.where(cols == i0[:, None], 1.0 - f[:, None], 0.0)
    w1 = jnp.where(cols == i1[:, None], f[:, None], 0.0)
    w = w0 + w1                          # i0 == i1 accumulates, as intended
    return w if dtype is None else w.astype(dtype)


def _take3(level: Array, i0: Array, i1: Array, f: Array, df: int) -> Array:
    """Separable resample with traced per-axis index/weight vectors.
    level (dl,dl,dl,C); i0,i1 (3,df) int32; f (3,df). -> (df,df,df,C).

    Each axis is one (df, dl) x (dl, ...) contraction (a matrix product)
    — the interpolation matrices are built on the fly from the index
    vectors, so scan carries only O(df) metadata per step while the FLOPs
    run as dense products instead of per-element gathers.  The z
    contraction's natural minor dim is only C (=4); a Kronecker (z,C)-
    fused form would pay C^2 structural-zero FLOPs and break fusion.

    The contractions run in `level.dtype` (bfloat16 for the tensor
    cores' bf16 rate) and accumulate/return float32.
    """
    dl = level.shape[0]
    wd = level.dtype
    wx = _interp_matrix(i0[0], i1[0], f[0], dl, wd)
    wy = _interp_matrix(i0[1], i1[1], f[1], dl, wd)
    wz = _interp_matrix(i0[2], i1[2], f[2], dl, wd)
    pref = dict(preferred_element_type=jnp.float32)
    out = jnp.einsum("ad,dyzc->ayzc", wx, level, **pref)
    out = jnp.einsum("bd,adzc->abzc", wy, out.astype(wd), **pref)
    out = jnp.einsum("ed,abdc->abec", wz, out.astype(wd), **pref)
    return out


def plan_groups(lods, num_levels):
    """(per-step lod plan, consecutive runs of the same (l0, l1) level
    pair) — shared by the local and brick-sharded dense marches."""
    plan = M._static_lod_plan(lods, num_levels)
    groups: list = []
    for k, (l0, l1, w) in enumerate(plan):
        l1e = l1 if w > 0.0 and l1 != l0 else l0
        if groups and groups[-1][0] == (l0, l1e):
            groups[-1][1].append(k)
        else:
            groups.append(((l0, l1e), [k]))
    return plan, groups


def directional_march_multi(
    mips: Sequence[Array],
    directions,                          # (B, 3) static unit world directions
    schedule: M.MarchSchedule,
    world_size: float,
    field_dim: Optional[int] = None,
    max_alpha: float = 0.95,
    occlusion_falloff: float = 0.03,
    opacity_gain: float = 1.0,
    transmittance_only: bool = False,
    compute_dtype=None,
) -> Array:
    """March the cone schedule from EVERY field voxel center along each of B
    fixed directions.  Returns (B, df, df, df, 4) = (color.rgb, occlusion)
    per direction — the vec4 the reference's Voxel_Cone_Tracing returns
    (fs:107) — or (B, df, df, df, 1) transmittance if transmittance_only.

    Exactly the per-point march of core/march.py evaluated at all voxel
    centers at once.  Compiled-code-size discipline: steps are grouped by
    the (static) mip-level pair they sample, each group is ONE lax.scan
    over its steps (shifts enter as traced index/weight vectors), and the
    whole march is vmapped over directions — so the compiled size is
    O(level pairs), independent of step count and direction count.

    compute_dtype=jnp.bfloat16 runs the resample contractions in bf16
    with float32 accumulation and compositing; the carry and output are
    always float32.
    """
    d0 = mips[0].shape[0]
    df = field_dim or d0
    dtype = jnp.float32
    if transmittance_only:
        # the transmittance march reads only alpha — resampling the rgb
        # channels too cost 4x the bandwidth (measured r4: the 256^3
        # shadow-volume build dropped ~3x from this slice)
        mips = [m[..., -1:] for m in mips]
    dirs = np.asarray(directions, np.float64)
    assert dirs.ndim == 2 and dirs.shape[1] == 3
    nb = dirs.shape[0]

    # anisotropic stack (core/aniso.py): levels >= 1 carry a 6-direction
    # axis.  The march direction is STATIC per vmapped lane, so the blend
    # weights are static too; directional levels are packed (d,d,d,6C) so
    # the separable resample stays 4-D, and the blend is one einsum after.
    from vct_tpu.core import aniso as Aniso
    aniso_w6 = jnp.asarray(
        np.stack([Aniso.aniso_weights_static(d) for d in dirs]))  # (B, 6)

    def _packed(lvl: int) -> Array:
        m = mips[lvl]
        if m.ndim == 5:
            dl = m.shape[0]
            return m.reshape(dl, dl, dl, -1)
        return m

    def _unblend(s: Array, w6: Array, lvl: int) -> Array:
        if mips[lvl].ndim == 5:
            c = mips[lvl].shape[-1]
            s = s.reshape(s.shape[:-1] + (6, c))
            return jnp.einsum("xyzsc,s->xyzc", s, w6)
        return s

    plan, groups = plan_groups(schedule.lods, len(mips))

    def axis_pack(steps, lvl):
        """(B, n, 3, df) i0/i1 int32 and f f32 for all steps at one level."""
        dl = mips[lvl].shape[0]
        i0s = np.empty((nb, len(steps), 3, df), np.int32)
        i1s = np.empty_like(i0s)
        fs = np.empty((nb, len(steps), 3, df), np.float32)
        for b in range(nb):
            for n, k in enumerate(steps):
                shift = dirs[b] * schedule.dists[k] / (world_size / dl)
                for ax in range(3):
                    i0, i1, f = _axis_indices(df, dl, float(shift[ax]))
                    i0s[b, n, ax] = i0
                    i1s[b, n, ax] = i1
                    fs[b, n, ax] = f
        return jnp.asarray(i0s), jnp.asarray(i1s), jnp.asarray(fs)

    def march_one(xs_groups, w6):
        t = jnp.ones((df, df, df, 1), dtype)
        color = None if transmittance_only else jnp.zeros((df, df, df, 3),
                                                          dtype)
        occ = None if transmittance_only else jnp.zeros((df, df, df, 1),
                                                        dtype)
        for ((l0, l1), steps), xs in zip(groups, xs_groups):
            two = l1 != l0
            la, lb = _packed(l0), _packed(l1)
            if compute_dtype is not None:
                la = la.astype(compute_dtype)
                lb = lb.astype(compute_dtype)

            def body(carry, x, two=two, la=la, lb=lb, l0=l0, l1=l1):
                s = _take3(la, x["a"][0], x["a"][1], x["a"][2], df)
                s = _unblend(s, w6, l0)
                if two:
                    s1 = _take3(lb, x["b"][0], x["b"][1], x["b"][2], df)
                    s1 = _unblend(s1, w6, l1)
                    s = s * (1.0 - x["w"]) + s1 * x["w"]
                a = s[..., -1:]
                if opacity_gain != 1.0:
                    a = jnp.minimum(a * opacity_gain, 1.0)
                if schedule.step_factor != 1.0:
                    keep = (1.0 - a) ** schedule.step_factor
                else:
                    keep = 1.0 - a
                if transmittance_only:
                    return (carry[0] * keep,), None
                t, color, occ = carry
                rgb = s[..., :3]
                if schedule.step_factor != 1.0:
                    # optical-depth correction (march.composite): one
                    # sample stands in for step_factor steps
                    scale = jnp.where(a > 1e-6, (1.0 - keep)
                                      / jnp.maximum(a, 1e-6),
                                      schedule.step_factor)
                    rgb = rgb * scale
                    a = 1.0 - keep
                # loop-top early-out (fs:94): stop once 1-T >= max_alpha
                active = (1.0 - t) < max_alpha
                wgt = jnp.where(active, t, 0.0)
                color = color + wgt * rgb
                occ = occ + wgt * a / x["atten"]
                t = jnp.where(active, t * keep, t)
                return (t, color, occ), None

            carry = (t,) if transmittance_only else (t, color, occ)
            if len(steps) == 1:
                carry, _ = body(carry, jax.tree_util.tree_map(
                    lambda v: v[0], xs))
            else:
                carry, _ = jax.lax.scan(body, carry, xs)
            if transmittance_only:
                (t,) = carry
            else:
                t, color, occ = carry
        if transmittance_only:
            return t
        return jnp.concatenate([color, occ], axis=-1)

    # pack per-group xs with a leading direction axis, vmap the march
    xs_all = []
    for (l0, l1), steps in groups:
        xs = {"a": axis_pack(steps, l0)}
        if l1 != l0:
            xs["b"] = axis_pack(steps, l1)
            xs["w"] = jnp.tile(
                jnp.asarray([plan[k][2] for k in steps], jnp.float32),
                (nb, 1))
        xs["atten"] = jnp.tile(jnp.asarray(
            [1.0 + occlusion_falloff * schedule.diameters[k] for k in steps],
            jnp.float32), (nb, 1))
        xs_all.append(xs)

    return jax.vmap(march_one)(xs_all, aniso_w6)


def directional_march(
    mips: Sequence[Array],
    direction: Sequence[float],          # unit world direction (static)
    schedule: M.MarchSchedule,
    world_size: float,
    field_dim: Optional[int] = None,
    max_alpha: float = 0.95,
    occlusion_falloff: float = 0.03,
    opacity_gain: float = 1.0,
    transmittance_only: bool = False,
    compute_dtype=None,
) -> Array:
    """Single-direction directional_march_multi (see above)."""
    out = directional_march_multi(
        mips, np.asarray(direction, np.float64)[None], schedule, world_size,
        field_dim=field_dim, max_alpha=max_alpha,
        occlusion_falloff=occlusion_falloff, opacity_gain=opacity_gain,
        transmittance_only=transmittance_only, compute_dtype=compute_dtype)
    return out[0]


# ---------------------------------------------------------------------------
# Direction basis for the gather-cone fields
# ---------------------------------------------------------------------------

def direction_basis(n: int = 26) -> np.ndarray:
    """A small world-space direction basis covering the sphere.

    26 = 6 faces + 12 edges + 8 corners of the cube (normalized) — ample
    angular resolution for 60-degree-aperture diffuse cones, whose lobes are
    low-pass by construction.
    """
    if n == 6:
        dirs = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                [0, 0, -1]]
    elif n == 26:
        dirs = []
        for x in (-1, 0, 1):
            for y in (-1, 0, 1):
                for z in (-1, 0, 1):
                    if x == y == z == 0:
                        continue
                    dirs.append([x, y, z])
    else:
        raise ValueError(f"unsupported basis size {n}")
    d = np.asarray(dirs, np.float64)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def basis_weights(dirs: Array, basis: np.ndarray, power: float = 8.0) -> Array:
    """Spherical interpolation weights of query dirs (..., 3) over the basis
    (B, 3): normalized max(cos,0)^power — a smooth partition of unity over
    the covered hemisphere around each query.

    Power-of-two exponents (the config defaults, 8/32) use repeated
    squaring: a transcendental pow per element is ~10x the VPU cost of
    log2(p) multiplies at 1080p-scale inputs."""
    cos = jnp.einsum("...i,bi->...b", dirs, jnp.asarray(basis))
    w = jnp.maximum(cos, 0.0)
    p = float(power)
    if p > 0 and p == int(p) and (int(p) & (int(p) - 1)) == 0:
        for _ in range(int(np.log2(int(p)))):
            w = w * w
    else:
        w = w ** power
    return w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-8)

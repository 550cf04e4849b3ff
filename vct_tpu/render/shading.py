"""Shading: indirect-term providers (percone / field) + the combine of
VoxelConeTracing.fs:165-228.

Direct diffuse + shadow, 6-cone indirect diffuse with cone-traced ambient
occlusion, Phong direct specular + 1-cone indirect specular, ambient term.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vct_tpu.config import VCTConfig
from vct_tpu.core import cones as C
from vct_tpu.core import dense as D
from vct_tpu.core import grid as G
from vct_tpu.core import march as M

Array = jax.Array


# ---------------------------------------------------------------------------
# schedules (all static from config)
# ---------------------------------------------------------------------------

def diffuse_schedule(cfg: VCTConfig) -> M.MarchSchedule:
    ca = cfg.cones
    return M.march_schedule(ca.diffuse_tan_half_angle,
                            cfg.grid.voxel_world_size, ca.max_distance,
                            ca.max_steps)


def specular_schedule(cfg: VCTConfig) -> M.MarchSchedule:
    ca = cfg.cones
    return M.march_schedule(ca.specular_tan_half_angle,
                            cfg.grid.voxel_world_size, ca.max_distance,
                            ca.max_steps)


def specular_field_schedule(cfg: VCTConfig) -> M.MarchSchedule:
    """The specular FIELD build's coarser schedule (see
    ConeSetConfig.field_specular_step_factor); percone keeps the exact
    specular_schedule."""
    ca = cfg.cones
    return M.march_schedule(
        ca.specular_tan_half_angle, cfg.grid.voxel_world_size,
        ca.max_distance, ca.max_steps,
        step_factor=ca.field_specular_step_factor)


def shadow_schedule(cfg: VCTConfig) -> M.MarchSchedule:
    """Shadow cones traverse the WHOLE grid (occluders can be anywhere),
    with denser steps (ShadowConfig.step_factor)."""
    md = cfg.shadow.max_distance
    if md is None:
        md = 3.0 ** 0.5 * cfg.grid.world_size
    return M.march_schedule(
        cfg.shadow.tan_half_angle, cfg.grid.voxel_world_size, md,
        cfg.cones.max_steps, step_factor=cfg.shadow.step_factor)


def field_dim(cfg: VCTConfig) -> int:
    if cfg.cones.field_dim is not None:
        return cfg.cones.field_dim
    return min(cfg.grid.dim, 128)


def _march_compute_dtype(cfg: VCTConfig):
    """Dense-march contraction dtype (GridConfig.compute)."""
    return jnp.bfloat16 if cfg.grid.compute == "bfloat16" else None


# ---------------------------------------------------------------------------
# shadow providers
# ---------------------------------------------------------------------------

def shadow_cone_value(
    mips: Sequence[Array],
    position: Array,             # (..., 3) surface point
    normal: Array,               # (..., 3)
    light_dir: Array,            # (3,) normalized, toward the light
    schedule: M.MarchSchedule,
    cfg: VCTConfig,
) -> Array:
    """Per-query shadow cone (mode="percone"): transmittance of a narrow
    cone toward the light through the occupancy pyramid, with per-sample
    opacity gain (ShadowConfig.opacity_gain) and step-density correction.
    Replaces the 4096^2 depth map + PCF (VoxelConeTracing.fs:132-163).
    Returns shadow in [0,1], 1 = fully lit.
    """
    voxel = cfg.grid.voxel_world_size
    start = position + normal * (voxel * cfg.shadow.normal_offset)
    d = jnp.broadcast_to(light_dir, start.shape)
    if schedule.num_steps == 0:
        return jnp.ones(position.shape[:-1], position.dtype)
    dists = jnp.asarray(schedule.dists, position.dtype)
    points = start[..., None, :] + dists[:, None] * d[..., None, :]
    samples = M.sample_schedule(
        mips, points, schedule.lods, cfg.grid.world_size, direction=d)
    a = jnp.minimum(samples[..., 3] * cfg.shadow.opacity_gain, 1.0)
    if schedule.step_factor != 1.0:
        keep = (1.0 - a) ** schedule.step_factor
    else:
        keep = 1.0 - a
    return jnp.prod(keep, axis=-1)


def _use_brick_sharding(cfg: VCTConfig, mesh) -> bool:
    """Route the dense marches through parallel/brick.py?  Requires a mesh
    with a populated model axis; anisotropic stacks stay local (brick.py
    is isotropic-only for now)."""
    if mesh is None or cfg.sharding.brick_parallel <= 1:
        return False
    if cfg.grid.anisotropic:
        raise NotImplementedError(
            "brick_parallel > 1 with anisotropic mips is not supported; "
            "set grid.anisotropic=False or brick_parallel=1")
    if mesh.shape[cfg.sharding.model_axis] != cfg.sharding.brick_parallel:
        raise ValueError(
            f"mesh '{cfg.sharding.model_axis}' axis is "
            f"{mesh.shape[cfg.sharding.model_axis]}, config asks "
            f"brick_parallel={cfg.sharding.brick_parallel}")
    return True


def build_light_volume(cfg: VCTConfig, unlit_mips: Sequence[Array],
                       light_dir=None, mesh=None) -> Array:
    """Dense light-transmittance volume at full grid resolution
    (mode="volume"). Exact shadow_cone_value at every voxel center.

    The march direction must be STATIC (the dense pass's shifts are
    compile-time constants); defaults to the config light.  A traced
    light direction (e.g. when optimizing it) requires shadow mode
    "percone" instead.

    With cfg.sharding.brick_parallel > 1 and a mesh, the march runs
    brick-sharded along x over the model axis (parallel/brick.py); the
    returned volume's x axis is sharded P(model).
    """
    if light_dir is None:
        light_dir = cfg.light.direction
    try:
        d = np.asarray(light_dir, np.float64)
    except Exception as e:
        raise ValueError(
            "shadow mode 'volume' needs a static (non-traced) light "
            "direction; use shadow mode 'percone' to differentiate or "
            "vary the light direction at runtime") from e
    d = d / np.linalg.norm(d)
    if _use_brick_sharding(cfg, mesh):
        from vct_tpu.parallel import brick
        return brick.sharded_directional_march(
            unlit_mips, d, shadow_schedule(cfg), cfg.grid.world_size,
            mesh, axis_name=cfg.sharding.model_axis,
            field_dim=cfg.grid.dim, opacity_gain=cfg.shadow.opacity_gain,
            transmittance_only=True)
    return D.directional_march(
        unlit_mips, d, shadow_schedule(cfg),
        cfg.grid.world_size, field_dim=cfg.grid.dim,
        opacity_gain=cfg.shadow.opacity_gain, transmittance_only=True,
        compute_dtype=_march_compute_dtype(cfg))


def shadow_volume_tap(cfg: VCTConfig, light_volume: Array, position: Array,
                      normal: Array) -> Array:
    """One trilinear tap of the transmittance volume at the offset surface
    point — the volumetric analogue of the reference's shadow-map lookup."""
    voxel = cfg.grid.voxel_world_size
    p = position + normal * (voxel * cfg.shadow.normal_offset)
    uvw = G.world_to_uvw(p, cfg.grid.world_size)
    return G.trilinear_sample(light_volume, uvw)[..., 0]


def pack_light_corners(light_volume: Array) -> Array:
    """(D,D,D,1) -> (D^3, 8): each cell's 2x2x2 trilinear corner
    neighborhood (edge-replicated +1 shifts), so a trilinear tap becomes
    ONE gather of a contiguous 8-value row + a weight dot instead of 8
    scattered reads (the radiance injection taps every surface sample).
    Corner order: bit2=dx, bit1=dy, bit0=dz."""
    v = light_volume[..., 0]
    corners = []
    for dx in (0, 1):
        vx = v if dx == 0 else jnp.concatenate([v[1:], v[-1:]], axis=0)
        for dy in (0, 1):
            vy = vx if dy == 0 else jnp.concatenate(
                [vx[:, 1:], vx[:, -1:]], axis=1)
            for dz in (0, 1):
                vz = vy if dz == 0 else jnp.concatenate(
                    [vy[:, :, 1:], vy[:, :, -1:]], axis=2)
                corners.append(vz)
    return jnp.stack(corners, axis=-1).reshape(-1, 8)


def shadow_volume_tap_packed(cfg: VCTConfig, packed: Array, dim: int,
                             position: Array, normal: Array) -> Array:
    """shadow_volume_tap against pack_light_corners output — identical
    math (coordinates pre-clamped to [0, D-1] texel space, which equals
    trilinear_sample's per-corner edge clamp)."""
    voxel = cfg.grid.voxel_world_size
    p = position + normal * (voxel * cfg.shadow.normal_offset)
    t = jnp.clip(G.world_to_uvw(p, cfg.grid.world_size) * dim - 0.5,
                 0.0, dim - 1.0)
    i0 = jnp.floor(t)
    f = t - i0
    i = i0.astype(jnp.int32)
    row = (i[..., 0] * dim + i[..., 1]) * dim + i[..., 2]
    corners = packed[row]                           # (..., 8)
    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    w = jnp.concatenate([
        (fx if k & 4 else 1.0 - fx) * (fy if k & 2 else 1.0 - fy)
        * (fz if k & 1 else 1.0 - fz) for k in range(8)], axis=-1)
    return jnp.sum(corners * w, axis=-1)


# ---------------------------------------------------------------------------
# indirect providers
# ---------------------------------------------------------------------------

def pixel_cone_dirs(cfg: VCTConfig, normal: Array, tangent: Array,
                    bitangent: Array) -> Array:
    """World-space diffuse cone directions per pixel: normalize(TBN @ dir_i)
    — fs:175,198. Returns (..., K, 3)."""
    tbn = C.tbn_matrix(tangent, bitangent, normal)
    return C.rotate_cones(
        tbn, jnp.asarray(C.CONE_DIRECTIONS[: cfg.cones.num_diffuse_cones]))


def indirect_diffuse_percone(
    cfg: VCTConfig, mips: Sequence[Array], position: Array, normal: Array,
    cone_dirs: Array,
) -> Tuple[Array, Array]:
    """Exact per-pixel 6-cone gather (fs:196-199)."""
    ca = cfg.cones
    start = position + normal * cfg.grid.voxel_world_size    # fs:92
    weights = tuple(float(w) for w in C.CONE_WEIGHTS[: ca.num_diffuse_cones])
    return M.cone_march_multi(
        mips, start, cone_dirs, weights, diffuse_schedule(cfg),
        cfg.grid.world_size, max_alpha=ca.max_alpha,
        occlusion_falloff=ca.occlusion_falloff)


def build_cone_field(cfg: VCTConfig, mips: Sequence[Array],
                     schedule: M.MarchSchedule, mesh=None) -> Array:
    """Cone-gather fields for the direction basis, stacked channelwise:
    (df, df, df, B*4) with per-direction (rgb, occlusion).

    With cfg.sharding.brick_parallel > 1 and a mesh, the marches run
    brick-sharded along x (parallel/brick.py); the field's x axis comes
    back sharded P(model)."""
    basis = D.direction_basis(cfg.cones.field_basis)
    df = field_dim(cfg)
    if _use_brick_sharding(cfg, mesh):
        from vct_tpu.parallel import brick
        fields = brick.sharded_directional_march_multi(
            mips, basis, schedule, cfg.grid.world_size, mesh,
            axis_name=cfg.sharding.model_axis, field_dim=df,
            max_alpha=cfg.cones.max_alpha,
            occlusion_falloff=cfg.cones.occlusion_falloff)
    else:
        fields = D.directional_march_multi(
            mips, basis, schedule, cfg.grid.world_size, field_dim=df,
            max_alpha=cfg.cones.max_alpha,
            occlusion_falloff=cfg.cones.occlusion_falloff,
            compute_dtype=_march_compute_dtype(cfg))   # (B, df,df,df, 4)
    return jnp.moveaxis(fields, 0, -2).reshape(df, df, df, -1)


def _field_tap(cfg: VCTConfig, field: Array, position: Array,
               normal: Array) -> Array:
    """Trilinear tap of the stacked fields at the offset point: (..., B, 4)."""
    p = position + normal * cfg.grid.voxel_world_size
    uvw = G.world_to_uvw(p, cfg.grid.world_size)
    out = G.trilinear_sample(field, uvw)
    return out.reshape(out.shape[:-1] + (cfg.cones.field_basis, 4))


def indirect_diffuse_field(
    cfg: VCTConfig, field: Array, position: Array, normal: Array,
    cone_dirs: Array,
) -> Tuple[Array, Array]:
    """Field-mode 6-cone gather: fold the cone weights and the spherical
    basis weights into one (..., B) weight vector, then one field tap."""
    basis = D.direction_basis(cfg.cones.field_basis)
    ca = cfg.cones
    wb = D.basis_weights(cone_dirs, basis, ca.basis_power_diffuse)  # (...,K,B)
    cw = jnp.asarray(C.CONE_WEIGHTS[: ca.num_diffuse_cones])
    w = jnp.einsum("k,...kb->...b", cw, wb)                          # (..., B)
    tap = _field_tap(cfg, field, position, normal)                   # (...,B,4)
    out = jnp.einsum("...b,...bc->...c", w, tap)
    return out[..., :3], out[..., 3]


def indirect_specular_percone(
    cfg: VCTConfig, mips: Sequence[Array], position: Array, normal: Array,
    refl_dir: Array,
) -> Tuple[Array, Array]:
    ca = cfg.cones
    start = position + normal * cfg.grid.voxel_world_size
    rgb, occ, _ = M.cone_march(
        mips, start, refl_dir, specular_schedule(cfg), cfg.grid.world_size,
        max_alpha=ca.max_alpha, occlusion_falloff=ca.occlusion_falloff)
    return rgb, occ


def indirect_specular_field(
    cfg: VCTConfig, field: Array, position: Array, normal: Array,
    refl_dir: Array,
) -> Tuple[Array, Array]:
    basis = D.direction_basis(cfg.cones.field_basis)
    w = D.basis_weights(refl_dir, basis, cfg.cones.basis_power_specular)
    tap = _field_tap(cfg, field, position, normal)
    out = jnp.einsum("...b,...bc->...c", w, tap)
    return out[..., :3], out[..., 3]


# ---------------------------------------------------------------------------
# the combine (fs:165-228)
# ---------------------------------------------------------------------------

def combine(
    cfg: VCTConfig,
    albedo: Array,               # (..., 3)
    spec_color: Array,           # (..., 3) after gray-fallback
    normal: Array,               # (..., 3) shading normal
    light_dir: Array,            # (3,)
    eye_dir: Array,              # (..., 3) normalize(camera - P), fs:183
    shadow: Array,               # (...,)
    ind_diffuse_rgb: Array,      # (..., 3)
    ind_diffuse_occ: Array,      # (...,)
    ind_spec_rgb: Array,         # (..., 3)
    ind_spec_occ: Array,         # (...,)
    shininess,                   # float or (...,) per-pixel Phong exponent
) -> Array:
    n = C.normalize(normal)
    l = light_dir
    e = eye_dir

    # DIFFUSE — fs:186-205
    cos_theta = jnp.maximum(jnp.sum(n * l, axis=-1), 0.0)
    direct_diffuse = shadow * cos_theta
    if not cfg.render.show_diffuse:
        direct_diffuse = jnp.zeros_like(direct_diffuse)
    if not cfg.render.show_indirect_diffuse:
        ind_diffuse_rgb = jnp.zeros_like(ind_diffuse_rgb)
    occlusion = 1.0 - ind_diffuse_occ                # fs:201
    diffuse_reflection = (
        direct_diffuse[..., None] + occlusion[..., None] * ind_diffuse_rgb
    ) * albedo                                       # fs:205

    # SPECULAR — fs:208-223
    # reflect(-L, N) = 2*dot(N,L)*N - L   (GLSL reflect(I,N) = I - 2 dot(N,I) N)
    spec_reflect = C.normalize(
        2.0 * jnp.sum(n * l, axis=-1, keepdims=True) * n - l)
    spec = jnp.maximum(jnp.sum(e * spec_reflect, axis=-1), 0.0) \
        ** jnp.asarray(shininess)
    direct_specular = spec * shadow
    if not cfg.render.show_specular:
        direct_specular = jnp.zeros_like(direct_specular)
    if not cfg.render.show_indirect_specular:
        ind_spec_rgb = jnp.zeros_like(ind_spec_rgb)
    if cfg.cones.trace_specular:
        spec_occlusion = 1.0 - ind_spec_occ          # fs:221 (uses .a = occlusion)
        specular_reflection = (
            ind_spec_rgb + spec_occlusion[..., None] * direct_specular[..., None]
        ) * spec_color                               # fs:223
    else:
        specular_reflection = jnp.zeros_like(diffuse_reflection)

    # AMBIENT — fs:225
    ambient = cfg.light.ambient_factor * albedo * occlusion[..., None]

    return ambient + diffuse_reflection + specular_reflection   # fs:227


def reflect_eye(normal: Array, eye_dir: Array) -> Array:
    """reflect(-E, N) = 2*dot(N,E)*N - E — the specular cone axis, fs:217."""
    n = C.normalize(normal)
    return C.normalize(
        2.0 * jnp.sum(n * eye_dir, axis=-1, keepdims=True) * n - eye_dir)


def spec_gray_fallback(spec: Array) -> Array:
    """specColor = length(spec.gb) > 0 ? spec : spec.rrr — fs:209-210."""
    gb = jnp.linalg.norm(spec[..., 1:3], axis=-1, keepdims=True)
    return jnp.where(gb > 0.0, spec, spec[..., 0:1])

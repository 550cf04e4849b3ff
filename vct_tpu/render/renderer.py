"""End-to-end renderer: scene -> voxel radiance pyramid -> image.

The pipeline mirrors the reference's pass structure (SURVEY.md §3) as
sequential jitted stages:

  reference                           here
  ---------                           ----
  DrawDepthTexture (shadow map)       shadow cones through the occupancy
                                      pyramid (cfg.shadow.mode="cone"), or
                                      render/shadowmap.py ("map")
  DrawVoxelTexture + glGenerateMipmap build_voxel_state(): splat albedo ->
                                      occupancy mips -> per-sample shadow ->
                                      splat radiance -> radiance mips
  Render() raster + fragment shader   raycast G-buffer + shading.shade()

Everything after host-side scene prep is jit-compatible and differentiable
w.r.t. material colors, light parameters, and (via inject_radiance) voxel
radiance itself.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vct_tpu.config import VCTConfig
from vct_tpu.core import aniso as A
from vct_tpu.core import camera as cameralib
from vct_tpu.core import cones as C
from vct_tpu.core import grid as G
from vct_tpu.render import shading
from vct_tpu.render.gbuffer import (DeviceScene, GBuffer,
                                    intersect_chunk_pinhole,
                                    hits_to_gbuffer, pinhole_constants,
                                    raycast_chunk)
from vct_tpu.render.voxelize import SurfaceSamples, generate_surface_samples, splat
from vct_tpu.scene import textures as TX
from vct_tpu.scene.mesh import Scene

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MaterialTable:
    """Material colors as device arrays, plus the per-material texture atlas
    (scene/textures.py) when any material carries textures.  With an atlas,
    albedo/specular fetches sample it per-uv (DiffuseTexture /
    SpecularTexture units, Mesh.h:89-111) and shading normals come from the
    height page (CalcBumpNormal, VoxelConeTracing.fs:108-126)."""

    albedo: Array      # (M, 4)
    specular: Array    # (M, 3)
    emissive: Array    # (M, 3)
    shininess: Array   # (M,) Phong exponent (MTL Ns; Mesh.h:86 default 20)
    atlas: Optional[TX.TextureAtlas] = None

    @staticmethod
    def from_scene(scene: Scene, dtype=jnp.float32,
                   texture_resolution: int = 256) -> "MaterialTable":
        atlas = None
        if TX.has_textures(scene.materials):
            atlas = TX.TextureAtlas.from_materials(
                scene.materials, texture_resolution)
        return MaterialTable(
            albedo=jnp.asarray([m.albedo for m in scene.materials], dtype),
            specular=jnp.asarray([m.specular for m in scene.materials], dtype),
            emissive=jnp.asarray([m.emissive for m in scene.materials], dtype),
            shininess=jnp.asarray([m.shininess for m in scene.materials],
                                  dtype),
            atlas=atlas,
        )

    def sample_albedo(self, material_id: Array, uv: Array) -> Array:
        """(..., 4) rgba at the given uv — texture(DiffuseTexture, tex)."""
        if self.atlas is not None:
            return TX.sample_atlas(self.atlas.albedo, material_id, uv)
        return self.albedo[material_id]

    def sample_specular(self, material_id: Array, uv: Array) -> Array:
        if self.atlas is not None:
            return TX.sample_atlas(self.atlas.specular, material_id, uv)
        return self.specular[material_id]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SamplesDevice:
    """Surface samples on device (static per scene)."""

    positions: Array     # (S, 3)
    normals: Array       # (S, 3)
    uvs: Array           # (S, 2)
    material_ids: Array  # (S,)

    @staticmethod
    def from_samples(s: SurfaceSamples, dtype=jnp.float32) -> "SamplesDevice":
        return SamplesDevice(
            positions=jnp.asarray(s.positions, dtype),
            normals=jnp.asarray(s.normals, dtype),
            uvs=jnp.asarray(s.uvs, dtype),
            material_ids=jnp.asarray(s.material_ids),
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class VoxelState:
    """The voxel pyramids + optional dense direction-major products:
    radiance mips (camera-pass cones), unlit albedo/occupancy mips (shadow
    cones), the light transmittance volume (shadow mode "volume"), and
    cone-gather fields for the direction basis (cone modes "field")."""

    radiance_mips: Tuple[Array, ...]
    unlit_mips: Tuple[Array, ...]
    light_volume: Optional[Array] = None      # (D, D, D, 1)
    diffuse_field: Optional[Array] = None     # (df, df, df, B*4)
    specular_field: Optional[Array] = None    # (df, df, df, B*4)
    shadow_map: Optional[Array] = None        # (S, S) depth, mode "map"


def prepare_scene(cfg: VCTConfig, scene: Scene, samples=None):
    """Host-side prep: device geometry, material table, surface samples.

    Pass `samples` to reuse an existing SamplesDevice — e.g. for a
    subdivided copy of the same surfaces (scene/mesh.subdivide_scene),
    whose voxelization is identical by construction.
    """
    ds = DeviceScene.from_scene(scene)
    mats = MaterialTable.from_scene(scene)
    if samples is None:
        host = generate_surface_samples(
            scene, cfg.grid.voxel_world_size,
            cfg.voxelize.samples_per_voxel_width)
        samples = SamplesDevice.from_samples(host)
    return ds, mats, samples


shadow_schedule = shading.shadow_schedule


def _radiance_mips(cfg: VCTConfig, lit: Array) -> Tuple[Array, ...]:
    """Radiance pyramid: anisotropic 6-direction pre-integrations when
    cfg.grid.anisotropic (core/aniso.py — the reference's acknowledged-
    missing feature, Voxel_Cone_Tracing.h:123-125), else isotropic box
    mips (glGenerateMipmap, Voxel_Cone_Tracing.h:248).  The unlit/shadow
    pyramid stays isotropic with conservative max-alpha regardless: shadow
    cones need occupancy, not view-dependent radiance."""
    if cfg.grid.anisotropic:
        return A.build_aniso_mips(lit, cfg.grid.num_levels)
    return G.build_mips(lit, cfg.grid.num_levels)


def light_direction(cfg: VCTConfig, dtype=jnp.float32) -> Array:
    """L = normalize(LightDirection) — fs:181."""
    l = jnp.asarray(cfg.light.direction, dtype)
    return l / jnp.linalg.norm(l)


def sample_indirect_diffuse(
    cfg: VCTConfig,
    radiance_mips,
    positions: Array,
    normals: Array,
    mesh=None,
) -> Tuple[Array, Array]:
    """6-cone indirect-diffuse gather at surface points through the current
    radiance pyramid — the cone trace inside the voxelization pass that the
    reference sketches for >2 bounces (README.md:14 "can increase to more
    bounce").  Cone frames come from a stable ONB around the face normal.
    Returns (rgb (S,3), occlusion (S,))."""
    t, bt = C.orthonormal_frame(normals)
    cone_dirs = shading.pixel_cone_dirs(cfg, normals, t, bt)
    if cfg.cones.diffuse_mode == "field":
        field = shading.build_cone_field(
            cfg, radiance_mips, shading.diffuse_schedule(cfg), mesh=mesh)
        return shading.indirect_diffuse_field(
            cfg, field, positions, normals, cone_dirs)
    return shading.indirect_diffuse_percone(
        cfg, radiance_mips, positions, normals, cone_dirs)


def _inject_bounce(
    cfg: VCTConfig,
    samples: SamplesDevice,
    albedo_rgb: Array,           # (S, 3)
    direct_radiance: Array,      # (S, 3) bounce-0 injection (lit + emissive)
    weights: Array,              # (S,)
    radiance_mips,
    mesh=None,
) -> Tuple[Array, ...]:
    """One extra GI bounce: gather indirect at every surface sample, add the
    Lambertian re-emission albedo * occlusion * indirect (the surface
    combine of fs:205 applied at the voxel sample), re-splat, rebuild mips."""
    ind_rgb, ind_occ = sample_indirect_diffuse(
        cfg, radiance_mips, samples.positions, samples.normals, mesh=mesh)
    bounce = albedo_rgb * (1.0 - ind_occ)[:, None] * ind_rgb
    lit = splat(samples.positions, direct_radiance + bounce, weights,
                cfg.grid.dim, cfg.grid.world_size, mode=cfg.voxelize.mode)
    return _radiance_mips(cfg, lit)


def build_voxel_state(
    cfg: VCTConfig,
    samples: SamplesDevice,
    mats: MaterialTable,
    light_dir: Optional[Array] = None,
    light_color: Optional[Array] = None,
    mesh=None,
) -> VoxelState:
    """Voxelization + radiance injection + mip build (startup passes §3.3).

    Stage 1: splat albedo -> unlit grid (rgb=mean albedo, a=occupancy).
    Stage 2: per-sample shadow via a cone toward the light through the
             occupancy pyramid (replaces Voxelization.fs:18-52's PCF lookup).
    Stage 3: splat albedo*light*shadow + emissive -> radiance grid
             (Voxelization.fs:88 stores albedo*shadow, occupancy 1.0).
    Stage 4: isotropic mip chains (Voxel_Cone_Tracing.h:248).
    Stage 5: optional extra GI bounces (light.gi_bounces > 2): re-gather +
             re-inject + rebuild mips per bounce.

    With cfg.sharding.brick_parallel > 1 pass the ('data','model') mesh:
    the dense marches (light volume, cone fields) run brick-sharded along
    x over the model axis (SURVEY.md §2.4 TP row; BASELINE config 5).
    """
    dim, ws = cfg.grid.dim, cfg.grid.world_size
    if light_dir is None:
        light_dir = light_direction(cfg)
    if light_color is None:
        light_color = jnp.asarray(cfg.light.color, jnp.float32)

    albedo = mats.sample_albedo(samples.material_ids, samples.uvs)   # (S, 4)
    emissive = mats.emissive[samples.material_ids]       # (S, 3)
    weights = jnp.ones(samples.positions.shape[0], albedo.dtype)

    unlit = splat(samples.positions, albedo[:, :3], weights, dim, ws,
                  mode=cfg.voxelize.mode)
    # conservative (max-alpha) mips: shadow cones must not leak through
    # thin occluders diluted by mean-reduction (see grid.downsample2x)
    unlit_mips = G.build_mips(unlit, cfg.grid.num_levels, alpha_mode="max")

    light_volume = None
    shadow_map = None
    if cfg.shadow.mode == "volume":
        # dense light-transmittance volume; per-sample shadow is one
        # corner-packed tap (one gather row per sample)
        light_volume = shading.build_light_volume(cfg, unlit_mips,
                                                  mesh=mesh)
        shadow = shading.shadow_volume_tap_packed(
            cfg, shading.pack_light_corners(light_volume), cfg.grid.dim,
            samples.positions, samples.normals)
    elif cfg.shadow.mode == "map":
        # reference parity: scatter-min depth map + PCF (/25 here, the
        # voxelize-pass normalization — Voxelization.fs:46)
        from vct_tpu.render import shadowmap as SM
        shadow_map = SM.build_shadow_map(cfg, samples.positions)
        shadow = SM.pcf_shadow(cfg, shadow_map, samples.positions,
                               normalization="voxelize")
    else:
        shadow = shading.shadow_cone_value(
            unlit_mips, samples.positions, samples.normals, light_dir,
            shading.shadow_schedule(cfg), cfg)

    radiance = albedo[:, :3] * light_color * shadow[:, None] + emissive
    lit = splat(samples.positions, radiance, weights, dim, ws,
                mode=cfg.voxelize.mode)
    radiance_mips = _radiance_mips(cfg, lit)

    for _ in range(max(0, cfg.light.gi_bounces - 2)):
        radiance_mips = _inject_bounce(
            cfg, samples, albedo[:, :3], radiance, weights, radiance_mips,
            mesh=mesh)

    diffuse_field = None
    if cfg.cones.diffuse_mode == "field":
        diffuse_field = shading.build_cone_field(
            cfg, radiance_mips, shading.diffuse_schedule(cfg), mesh=mesh)
    specular_field = None
    if cfg.cones.trace_specular and cfg.cones.specular_mode == "field":
        specular_field = shading.build_cone_field(
            cfg, radiance_mips, shading.specular_field_schedule(cfg),
            mesh=mesh)

    return VoxelState(
        radiance_mips=radiance_mips,
        unlit_mips=unlit_mips,
        light_volume=light_volume,
        diffuse_field=diffuse_field,
        specular_field=specular_field,
        shadow_map=shadow_map,
    )


# --- staged build: separately-jitted stages (VCTConfig is hashable, so it
# rides as a static arg).  Each stage compiles on its own, with results
# identical to build_voxel_state.  Use for interactive/bench paths; the
# single-function build_voxel_state remains for end-to-end autodiff.

@partial(jax.jit, static_argnums=0)
def _stage_unlit(cfg: VCTConfig, samples: SamplesDevice,
                 mats: MaterialTable):
    albedo = mats.sample_albedo(samples.material_ids, samples.uvs)
    weights = jnp.ones(samples.positions.shape[0], albedo.dtype)
    unlit = splat(samples.positions, albedo[:, :3], weights,
                  cfg.grid.dim, cfg.grid.world_size, mode=cfg.voxelize.mode)
    return G.build_mips(unlit, cfg.grid.num_levels, alpha_mode="max")


@partial(jax.jit, static_argnums=0, static_argnames=("mesh",))
def _stage_light_volume(cfg: VCTConfig, unlit_mips, mesh=None):
    return shading.build_light_volume(cfg, unlit_mips, mesh=mesh)


@partial(jax.jit, static_argnums=0)
def _stage_shadow_map(cfg: VCTConfig, samples: SamplesDevice):
    from vct_tpu.render import shadowmap as SM
    return SM.build_shadow_map(cfg, samples.positions)


@partial(jax.jit, static_argnums=0)
def _stage_radiance(cfg: VCTConfig, samples: SamplesDevice,
                    mats: MaterialTable, unlit_mips, light_volume,
                    shadow_map, light_dir, light_color):
    albedo = mats.sample_albedo(samples.material_ids, samples.uvs)
    emissive = mats.emissive[samples.material_ids]
    weights = jnp.ones(samples.positions.shape[0], albedo.dtype)
    if cfg.shadow.mode == "volume":
        shadow = shading.shadow_volume_tap_packed(
            cfg, shading.pack_light_corners(light_volume), cfg.grid.dim,
            samples.positions, samples.normals)
    elif cfg.shadow.mode == "map":
        from vct_tpu.render import shadowmap as SM
        shadow = SM.pcf_shadow(cfg, shadow_map, samples.positions,
                               normalization="voxelize")
    else:
        shadow = shading.shadow_cone_value(
            unlit_mips, samples.positions, samples.normals, light_dir,
            shading.shadow_schedule(cfg), cfg)
    radiance = albedo[:, :3] * light_color * shadow[:, None] + emissive
    lit = splat(samples.positions, radiance, weights,
                cfg.grid.dim, cfg.grid.world_size, mode=cfg.voxelize.mode)
    return _radiance_mips(cfg, lit), radiance


@partial(jax.jit, static_argnums=0)
def _stage_bounce(cfg: VCTConfig, samples: SamplesDevice,
                  mats: MaterialTable, direct_radiance, radiance_mips):
    albedo = mats.sample_albedo(samples.material_ids, samples.uvs)
    weights = jnp.ones(samples.positions.shape[0], albedo.dtype)
    return _inject_bounce(cfg, samples, albedo[:, :3], direct_radiance,
                          weights, radiance_mips)


@partial(jax.jit, static_argnums=(0, 2), static_argnames=("mesh",))
def _stage_field(cfg: VCTConfig, radiance_mips, which: str, mesh=None):
    sched = (shading.diffuse_schedule(cfg) if which == "diffuse"
             else shading.specular_field_schedule(cfg))
    return shading.build_cone_field(cfg, radiance_mips, sched, mesh=mesh)


def build_voxel_state_staged(
    cfg: VCTConfig,
    samples: SamplesDevice,
    mats: MaterialTable,
    light_dir: Optional[Array] = None,
    light_color: Optional[Array] = None,
    mesh=None,
) -> VoxelState:
    """build_voxel_state with per-stage jit boundaries (same results)."""
    if light_dir is None:
        light_dir = light_direction(cfg)
    if light_color is None:
        light_color = jnp.asarray(cfg.light.color, jnp.float32)
    unlit_mips = _stage_unlit(cfg, samples, mats)
    light_volume = (_stage_light_volume(cfg, unlit_mips, mesh=mesh)
                    if cfg.shadow.mode == "volume" else None)
    shadow_map = (_stage_shadow_map(cfg, samples)
                  if cfg.shadow.mode == "map" else None)
    radiance_mips, direct_radiance = _stage_radiance(
        cfg, samples, mats, unlit_mips, light_volume, shadow_map,
        light_dir, light_color)
    for _ in range(max(0, cfg.light.gi_bounces - 2)):
        radiance_mips = _stage_bounce(
            cfg, samples, mats, direct_radiance, radiance_mips)
    diffuse_field = (_stage_field(cfg, radiance_mips, "diffuse", mesh=mesh)
                     if cfg.cones.diffuse_mode == "field" else None)
    specular_field = (
        _stage_field(cfg, radiance_mips, "specular", mesh=mesh)
        if cfg.cones.trace_specular and cfg.cones.specular_mode == "field"
        else None)
    return VoxelState(
        radiance_mips=radiance_mips,
        unlit_mips=unlit_mips,
        light_volume=light_volume,
        diffuse_field=diffuse_field,
        specular_field=specular_field,
        shadow_map=shadow_map,
    )


def shade_gbuffer(
    cfg: VCTConfig,
    voxels: VoxelState,
    gbuf: GBuffer,
    mats: MaterialTable,
    camera_position: Array,
    light_dir: Optional[Array] = None,
) -> Array:
    """Fragment-stage equivalent: G-buffer -> linear RGB image."""
    if light_dir is None:
        light_dir = light_direction(cfg)

    albedo4 = mats.sample_albedo(gbuf.material, gbuf.uv)         # (..., 4)
    spec = shading.spec_gray_fallback(
        mats.sample_specular(gbuf.material, gbuf.uv))
    # shading normal: bump-mapped when a texture atlas is present
    # (N = CalcBumpNormal(TBN), fs:177); cone TBN keeps the vertex frame
    if mats.atlas is not None:
        shade_normal = TX.bump_normal(
            mats.atlas, gbuf.material, gbuf.uv, gbuf.tangent,
            gbuf.bitangent, gbuf.normal)
    else:
        shade_normal = gbuf.normal

    if cfg.shadow.mode == "volume":
        shadow = shading.shadow_volume_tap(
            cfg, voxels.light_volume, gbuf.position, gbuf.geo_normal)
    elif cfg.shadow.mode == "map":
        # main-pass PCF — the /9-quirk normalization under "reference"
        # (VoxelConeTracing.fs:158)
        from vct_tpu.render import shadowmap as SM
        shadow = SM.pcf_shadow(cfg, voxels.shadow_map, gbuf.position,
                               normalization="main")
    else:
        shadow = shading.shadow_cone_value(
            voxels.unlit_mips, gbuf.position, gbuf.geo_normal, light_dir,
            shading.shadow_schedule(cfg), cfg)

    cone_dirs = shading.pixel_cone_dirs(
        cfg, gbuf.normal, gbuf.tangent, gbuf.bitangent)
    if cfg.cones.diffuse_mode == "field":
        ind_d_rgb, ind_d_occ = shading.indirect_diffuse_field(
            cfg, voxels.diffuse_field, gbuf.position, gbuf.normal, cone_dirs)
    else:
        ind_d_rgb, ind_d_occ = shading.indirect_diffuse_percone(
            cfg, voxels.radiance_mips, gbuf.position, gbuf.normal, cone_dirs)

    eye = shading.C.normalize(camera_position - gbuf.position)   # fs:183
    if cfg.cones.trace_specular:
        refl = shading.reflect_eye(shade_normal, eye)    # reflect(-E, N), fs:217
        if cfg.cones.specular_mode == "field":
            ind_s_rgb, ind_s_occ = shading.indirect_specular_field(
                cfg, voxels.specular_field, gbuf.position, gbuf.normal, refl)
        else:
            ind_s_rgb, ind_s_occ = shading.indirect_specular_percone(
                cfg, voxels.radiance_mips, gbuf.position, gbuf.normal, refl)
    else:
        ind_s_rgb = jnp.zeros_like(ind_d_rgb)
        ind_s_occ = jnp.zeros_like(ind_d_occ)

    rgb = shading.combine(
        cfg,
        albedo=albedo4[..., :3],
        spec_color=spec,
        normal=shade_normal,
        light_dir=light_dir,
        eye_dir=eye,
        shadow=shadow,
        ind_diffuse_rgb=ind_d_rgb,
        ind_diffuse_occ=ind_d_occ,
        ind_spec_rgb=ind_s_rgb,
        ind_spec_occ=ind_s_occ,
        # per-material Phong exponent (scene/obj.py reads MTL Ns); the
        # reference hardcodes 20 for every mesh (Mesh.h:86)
        shininess=mats.shininess[gbuf.material],
    )
    # alpha-mask discard (fs:169-172) + miss -> background
    bg = jnp.asarray(cfg.render.background, rgb.dtype)
    visible = gbuf.hit & (albedo4[..., 3] >= cfg.render.alpha_threshold)
    return jnp.where(visible[..., None], rgb, bg)


def alpha_mask_recast(cfg: VCTConfig, mats: MaterialTable, gbuf_of, trace,
                      t: Array, tri: Array) -> Tuple[Array, Array]:
    """Alpha-mask SEE-THROUGH (fs:169-172): the reference's `discard`
    drops the masked fragment so the depth-tested surface BEHIND it
    renders.  Re-cast rays whose hit sampled albedo-alpha below the
    threshold with a per-ray tmin just past the masked hit, up to
    cfg.render.alpha_mask_depth times (deeper masked stacks fall back to
    the background, the documented bounded deviation).  Applies only when
    materials carry a texture atlas — the reference reads alpha from
    DiffuseTexture (fs:167), so constant-albedo scenes never discard.

    t (N,) closest hits (+inf on a miss) and tri (N,) their triangles;
    gbuf_of(t, tri) -> GBuffer of the same rays; trace(tmin) -> (t, tri)
    with hits at t > tmin only (tmin = +inf retires a ray).  A re-cast
    runs only when some ray is masked (lax.cond)."""
    if cfg.render.alpha_mask_depth <= 0 or mats.atlas is None:
        return t, tri
    for _ in range(cfg.render.alpha_mask_depth):
        g = gbuf_of(t, tri)
        alpha = mats.sample_albedo(g.material, g.uv)[..., 3]
        masked = g.hit & (alpha < cfg.render.alpha_threshold)
        # epsilon in both relative and absolute terms so the SAME surface
        # (t within float rounding) cannot re-win
        tmin = jnp.where(masked, t * (1.0 + 1e-5) + 1e-4, jnp.inf)
        t2, tri2 = jax.lax.cond(jnp.any(masked), trace,
                                lambda _: (t, tri), tmin)
        t = jnp.where(masked, t2, t)
        tri = jnp.where(masked, tri2, tri)
    return t, tri


def render_rays(
    cfg: VCTConfig,
    ds: DeviceScene,
    voxels: VoxelState,
    mats: MaterialTable,
    origins: Array,
    dirs: Array,
    camera_position: Array,
    light_dir: Optional[Array] = None,
    chunk_size: int = 4096,
    pinhole: bool = True,
) -> Array:
    """Raycast + shade, fused per pixel chunk (lax.map) so intermediates
    (G-buffer attrs, field taps) stay chunk-sized — full-frame shading
    intermediates at 1080p would be ~GBs.

    pinhole=True (the camera-ray case: all origins equal by construction,
    core/camera.py primary_rays) uses the matmul intersection fast path;
    set False for rays with varying origins."""
    shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    n = o.shape[0]
    pad = (-n) % chunk_size
    if pad:
        o = jnp.concatenate([o, jnp.zeros((pad, 3), o.dtype)])
        d = jnp.concatenate([d, jnp.ones((pad, 3), d.dtype)])

    if pinhole:
        origin0 = o[0]
        pc = pinhole_constants(ds, origin0)

        def chunk_fn(dc):
            def gbuf_of(t, tri):
                return hits_to_gbuffer(ds, pc, origin0, dc, t, tri)

            t, tri = intersect_chunk_pinhole(dc, pc)
            t, tri = alpha_mask_recast(
                cfg, mats, gbuf_of,
                lambda tmin: intersect_chunk_pinhole(dc, pc, tmin=tmin),
                t, tri)
            return shade_gbuffer(cfg, voxels, gbuf_of(t, tri), mats,
                                 camera_position, light_dir)

        rgb = jax.lax.map(chunk_fn, d.reshape(-1, chunk_size, 3))
    else:
        def chunk_fn(args):
            oc, dc = args
            gbuf = raycast_chunk(ds, oc, dc)
            return shade_gbuffer(cfg, voxels, gbuf, mats, camera_position,
                                 light_dir)

        rgb = jax.lax.map(
            chunk_fn,
            (o.reshape(-1, chunk_size, 3), d.reshape(-1, chunk_size, 3)))
    return rgb.reshape(-1, 3)[:n].reshape(shape + (3,))


def render_camera_pass(
    cfg: VCTConfig,
    ds: DeviceScene,
    voxels: VoxelState,
    mats: MaterialTable,
    origins: Array,
    dirs: Array,
    camera_position: Array,
    light_dir: Optional[Array] = None,
    chunk_size: Optional[int] = None,
) -> Array:
    """The per-frame camera pass for the default backend: on a GPU the
    binned Triton raycast + chunked XLA shading (render/fast.py); on the
    CPU render_rays, the brute-force oracle the tests compare against.
    chunk_size: pixels per shading chunk (None: the callee's default)."""
    kw = {} if chunk_size is None else {"chunk_size": chunk_size}
    backend = jax.default_backend()
    if backend == "gpu":
        from vct_tpu.render import fast as F
        return F.render_frame(cfg, ds, voxels, mats, origins, dirs,
                              camera_position, light_dir, **kw)
    if backend == "cpu":
        return render_rays(cfg, ds, voxels, mats, origins, dirs,
                           camera_position, light_dir, **kw)
    raise NotImplementedError(f"no camera pass for backend {backend!r}")


def render_image(
    cfg: VCTConfig,
    scene: Scene,
    camera: Optional[cameralib.Camera] = None,
    jit: bool = True,
) -> np.ndarray:
    """Convenience one-shot: prepare, voxelize, render. Returns (H, W, 3)."""
    if camera is None:
        camera = cameralib.Camera()
    ds, mats, samples = prepare_scene(cfg, scene)
    origins, dirs = cameralib.primary_rays(
        camera, cfg.render.width, cfg.render.height)
    cam_pos = jnp.asarray(camera.position, jnp.float32)

    def pipeline(origins, dirs, cam_pos, samples, mats):
        voxels = build_voxel_state(cfg, samples, mats)
        return render_camera_pass(cfg, ds, voxels, mats, origins, dirs,
                                  cam_pos)

    fn = jax.jit(pipeline) if jit else pipeline
    return np.asarray(fn(origins, dirs, cam_pos, samples, mats))

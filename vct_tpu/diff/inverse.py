"""Inverse rendering: optimize scene parameters against target images.

The reference has no autodiff at all (SURVEY.md §2.4 "gradient sync:
absent — no gradients at all"); this subsystem is the framework's
config-4 deliverable: the whole pipeline — voxelization, shadow, mip
build, cone march, shading combine — is one jitted differentiable
function, so `jax.grad` reaches material albedos, texture pages, light
parameters, and the voxel radiance grid itself.

Optimizable parameter sets (InverseConfig.optimize):
  "albedo"       material albedo table (M, 4)
  "textures"     albedo atlas pages (M, R, R, 4), when the scene has them
  "light"        light color (3,)
  "radiance"     the level-0 radiance grid directly (D, D, D, 4) — the
                 radiance-field mode; re-mips (and re-fields) per step so
                 gradients flow through the pyramid build

Distribution: single-device here; the tile-DP sharded step lives in
parallel/tile_dp.sharded_train_step_fn (same loss, mesh-annotated).
Checkpoint/resume: diff/checkpoint.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from vct_tpu.config import VCTConfig
from vct_tpu.render import renderer as R
from vct_tpu.render import shading

Array = jax.Array
Params = Dict[str, Array]


@dataclasses.dataclass(frozen=True)
class InverseConfig:
    """What to optimize and how."""

    optimize: Tuple[str, ...] = ("albedo",)
    learning_rate: float = 5e-2
    num_steps: int = 200
    loss: str = "l2"                  # "l2" | "l1"
    chunk_size: int = 4096
    # camera pass inside the loss: "xla" = render_rays, the brute-force
    # oracle; "fast" = renderer.render_camera_pass, the backend's camera
    # pass (on a GPU the binned Triton raycast + XLA shading; the raycast
    # outputs carry no gradient, so gradients flow through shading as in
    # render_rays).
    camera_pass: str = "xla"          # "xla" | "fast"


@dataclasses.dataclass
class OptimState:
    """Optimization state (checkpointable pytree-of-arrays + step)."""

    params: Params
    opt_state: tuple
    step: int = 0


def init_params(inv: InverseConfig, cfg: VCTConfig, mats: R.MaterialTable,
                voxels: Optional[R.VoxelState] = None) -> Params:
    """Initial parameter pytree from the current scene state."""
    params: Params = {}
    for name in inv.optimize:
        if name == "albedo":
            params["albedo"] = mats.albedo
        elif name == "textures":
            if mats.atlas is None:
                raise ValueError("optimize='textures' needs a texture atlas")
            params["textures"] = mats.atlas.albedo
        elif name == "light":
            params["light"] = jnp.asarray(cfg.light.color, jnp.float32)
        elif name == "radiance":
            if voxels is None:
                raise ValueError("optimize='radiance' needs a VoxelState")
            params["radiance"] = voxels.radiance_mips[0]
        else:
            raise ValueError(f"unknown optimize target {name!r}")
    return params


def _apply_params(inv: InverseConfig, cfg: VCTConfig, params: Params,
                  samples: R.SamplesDevice, mats: R.MaterialTable):
    """Rebuild (mats, voxels, light_color) from the parameter pytree.

    Everything is re-derived inside the traced function so gradients flow
    through voxelization + mip build (radiance mode re-mips the grid)."""
    if "albedo" in params:
        mats = dataclasses.replace(mats, albedo=params["albedo"])
    if "textures" in params:
        mats = dataclasses.replace(
            mats, atlas=dataclasses.replace(mats.atlas,
                                            albedo=params["textures"]))
    light_color = params.get("light")
    if "radiance" in params:
        voxels = voxel_state_from_radiance(
            cfg, params["radiance"], samples, mats, light_color=light_color)
    else:
        voxels = R.build_voxel_state(cfg, samples, mats,
                                     light_color=light_color)
    return mats, voxels


def voxel_state_from_radiance(
    cfg: VCTConfig,
    radiance: Array,                    # (D, D, D, 4) level-0 grid
    samples: R.SamplesDevice,
    mats: R.MaterialTable,
    light_color: Optional[Array] = None,
) -> R.VoxelState:
    """VoxelState with the radiance grid INJECTED instead of splatted:
    the radiance-field path — mips/fields/shadow derive from the given
    grid, so grads reach every voxel."""
    del light_color
    from vct_tpu.core import grid as G
    from vct_tpu.render.voxelize import splat

    albedo = mats.sample_albedo(samples.material_ids, samples.uvs)
    weights = jnp.ones(samples.positions.shape[0], albedo.dtype)
    unlit = splat(samples.positions, albedo[:, :3], weights, cfg.grid.dim,
                  cfg.grid.world_size, mode=cfg.voxelize.mode)
    unlit_mips = G.build_mips(unlit, cfg.grid.num_levels, alpha_mode="max")
    radiance_mips = R._radiance_mips(cfg, radiance)
    light_volume = (shading.build_light_volume(cfg, unlit_mips)
                    if cfg.shadow.mode == "volume" else None)
    diffuse_field = (shading.build_cone_field(
        cfg, radiance_mips, shading.diffuse_schedule(cfg))
        if cfg.cones.diffuse_mode == "field" else None)
    specular_field = (shading.build_cone_field(
        cfg, radiance_mips, shading.specular_field_schedule(cfg))
        if cfg.cones.trace_specular and cfg.cones.specular_mode == "field"
        else None)
    return R.VoxelState(
        radiance_mips=radiance_mips, unlit_mips=unlit_mips,
        light_volume=light_volume, diffuse_field=diffuse_field,
        specular_field=specular_field)


def make_loss_fn(
    inv: InverseConfig,
    cfg: VCTConfig,
    ds,                                  # DeviceScene
    camera_position: Array,
) -> Callable:
    """loss(params, samples, mats, origins, dirs, target) -> scalar."""

    def loss_fn(params, samples, mats, origins, dirs, target):
        mats2, voxels = _apply_params(inv, cfg, params, samples, mats)
        if inv.camera_pass == "fast":
            img = R.render_camera_pass(cfg, ds, voxels, mats2, origins, dirs,
                                       camera_position,
                                       chunk_size=inv.chunk_size)
        else:
            img = R.render_rays(cfg, ds, voxels, mats2, origins, dirs,
                                camera_position, chunk_size=inv.chunk_size)
        err = img - target
        if inv.loss == "l1":
            return jnp.mean(jnp.abs(err))
        return jnp.mean(err * err)

    return loss_fn


def make_step_fn(
    inv: InverseConfig,
    cfg: VCTConfig,
    ds,
    camera_position: Array,
    optimizer: Optional[optax.GradientTransformation] = None,
):
    """Jitted (params, opt_state, samples, mats, origins, dirs, target)
    -> (params, opt_state, loss)."""
    if optimizer is None:
        optimizer = optax.adam(inv.learning_rate)
    loss_fn = make_loss_fn(inv, cfg, ds, camera_position)

    @jax.jit
    def step(params, opt_state, samples, mats, origins, dirs, target):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, samples, mats, origins, dirs, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step, optimizer


def optimize(
    inv: InverseConfig,
    cfg: VCTConfig,
    scene,
    target: Array,                      # (H, W, 3) target image
    camera=None,
    init: Optional[Params] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    log_every: int = 0,
) -> Tuple[OptimState, List[float]]:
    """Run the inverse optimization; returns final state + loss history.

    With checkpoint_dir set, resumes from the latest checkpoint there and
    saves every checkpoint_every steps (diff/checkpoint.py).
    """
    from vct_tpu.core import camera as cameralib

    if camera is None:
        camera = cameralib.Camera()
    ds, mats, samples = R.prepare_scene(cfg, scene)
    origins, dirs = cameralib.primary_rays(
        camera, target.shape[1], target.shape[0])
    cam_pos = jnp.asarray(camera.position, jnp.float32)
    target = jnp.asarray(target, jnp.float32)

    step_fn, optimizer = make_step_fn(inv, cfg, ds, cam_pos)
    if init is None:
        voxels = (R.build_voxel_state(cfg, samples, mats)
                  if "radiance" in inv.optimize else None)
        init = init_params(inv, cfg, mats, voxels)
    state = OptimState(params=init, opt_state=optimizer.init(init), step=0)

    if checkpoint_dir is not None:
        from vct_tpu.diff import checkpoint as ckpt
        restored = ckpt.restore_latest(checkpoint_dir, state)
        if restored is not None:
            state = restored

    history: List[float] = []
    while state.step < inv.num_steps:
        params, opt_state, loss = step_fn(
            state.params, state.opt_state, samples, mats, origins, dirs,
            target)
        state = OptimState(params=params, opt_state=opt_state,
                           step=state.step + 1)
        history.append(float(loss))
        if log_every and state.step % log_every == 0:
            print(f"step {state.step}: loss {history[-1]:.6f}")
        if (checkpoint_dir is not None and checkpoint_every
                and state.step % checkpoint_every == 0):
            from vct_tpu.diff import checkpoint as ckpt
            ckpt.save(checkpoint_dir, state)
    if checkpoint_dir is not None:
        from vct_tpu.diff import checkpoint as ckpt
        ckpt.save(checkpoint_dir, state)
    return state, history

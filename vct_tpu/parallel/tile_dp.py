"""Tile data parallelism + the sharded render/train steps.

The forward renderer is elementwise over pixels once the voxel state is
built, so tile-DP is pure sharding annotation: rays sharded over 'data',
voxel pyramid + materials replicated, image comes back sharded over 'data'.
Voxelization surface samples shard over 'model'; the scatter-add partial
grids all-reduce automatically (jit + sharding propagation inserts the
psum — SURVEY.md §2.4 "gradient/parameter sync" row covers the backward).

The inverse-rendering train step (BASELINE.json config 4) jits loss+grad
over the same mesh: pixel loss terms reduce over 'data', sample splats over
model', and parameter gradients arrive replicated (XLA all-reduce over
the device interconnect), overlapped with the backward march by the
scheduler.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from vct_tpu.config import VCTConfig
from vct_tpu.parallel import mesh as meshlib
from vct_tpu.render import renderer as R
from vct_tpu.render.gbuffer import DeviceScene

Array = jax.Array


def sharded_build_fn(cfg: VCTConfig, mesh: Mesh):
    """Compile the tile-DP voxel-state build: (samples, mats) -> voxels.

    Surface samples shard over 'model' (the scatter-add partial grids
    all-reduce automatically); the voxel state comes back replicated —
    it is model state, identical on every device, consumed by the
    data-scaled camera pass."""
    repl = meshlib.replicated(mesh)
    samp_s = meshlib.samples_sharding(mesh)
    samples_shardings = R.SamplesDevice(
        positions=samp_s, normals=samp_s, uvs=samp_s, material_ids=samp_s)

    def fn(samples, mats):
        return R.build_voxel_state(cfg, samples, mats)

    return jax.jit(fn, in_shardings=(samples_shardings, repl),
                   out_shardings=repl)


def shardmap_camera_fn(
    cfg: VCTConfig,
    ds: DeviceScene,
    mesh: Mesh,
    chunk_size: int = 4096,
):
    """The tile-DP camera pass as an explicit shard_map: each device runs
    renderer.render_camera_pass (the binned raycast on a GPU) on its own
    image-row block with the voxel state replicated — ZERO collectives
    by construction.  Mapping per device makes the pinhole origin o[0]
    the LOCAL first origin (identical for every camera ray) and the chunk
    reshape local; a jit+sharding form would leave the partitioner room
    to insert all-gathers for both.

    Image rows must divide the 'data' axis size."""
    def local(origins, dirs, cam_pos, voxels, mats):
        return R.render_camera_pass(cfg, ds, voxels, mats, origins, dirs,
                                    cam_pos, chunk_size=chunk_size)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data"), P("data"), P(), P(), P()),
        out_specs=P("data"),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_render_fn(
    cfg: VCTConfig,
    ds: DeviceScene,
    mesh: Mesh,
    chunk_size: int = 4096,
):
    """Compile a tile-DP renderer: (origins, dirs, cam_pos, samples, mats)
    -> image, with rays/image sharded over 'data' and the voxel build's
    surface samples sharded over 'model'."""
    rays_s = meshlib.rays_sharding(mesh)
    repl = meshlib.replicated(mesh)
    samp_s = meshlib.samples_sharding(mesh)
    samples_shardings = R.SamplesDevice(
        positions=samp_s, normals=samp_s, uvs=samp_s, material_ids=samp_s)
    # prefix-pytree sharding: `repl` broadcasts over every MaterialTable
    # leaf, including the optional texture atlas
    mats_shardings = repl

    def fn(origins, dirs, cam_pos, samples, mats):
        voxels = R.build_voxel_state(cfg, samples, mats)
        return R.render_rays(cfg, ds, voxels, mats, origins, dirs, cam_pos,
                             chunk_size=chunk_size)

    return jax.jit(
        fn,
        in_shardings=(rays_s, rays_s, repl, samples_shardings,
                      mats_shardings),
        out_shardings=rays_s,
    )


def pad_samples(samples: "R.SamplesDevice", multiple: int) -> "R.SamplesDevice":
    """Pad surface-sample arrays so the 'model'-sharded dim divides evenly.

    Pad samples sit far outside the grid, so splat() drops them (the
    `inside` mask in render/voxelize.py) — a true no-op on results.
    """
    n = samples.positions.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return samples
    far = jnp.full((pad, 3), 1e6, samples.positions.dtype)
    return R.SamplesDevice(
        positions=jnp.concatenate([samples.positions, far]),
        normals=jnp.concatenate(
            [samples.normals, jnp.zeros((pad, 3), samples.normals.dtype)]),
        uvs=jnp.concatenate(
            [samples.uvs, jnp.zeros((pad, 2), samples.uvs.dtype)]),
        material_ids=jnp.concatenate(
            [samples.material_ids,
             jnp.zeros((pad,), samples.material_ids.dtype)]),
    )


@dataclasses.dataclass
class TrainState:
    """Inverse-rendering optimization state (BASELINE.json config 4)."""

    albedo: Array          # (M, 4) material albedo being optimized
    light_color: Array     # (3,)
    opt_state: tuple       # optax state


def sharded_train_step_fn(
    cfg: VCTConfig,
    ds: DeviceScene,
    mesh: Mesh,
    optimizer,
    chunk_size: int = 4096,
):
    """Compile one optimization step of the inverse pass over the mesh.

    (params, opt_state, origins, dirs, cam_pos, samples, mats, target)
    -> (params, opt_state, loss). Rays + target sharded over 'data';
    params replicated; gradient all-reduce is XLA-inserted.
    """
    rays_s = meshlib.rays_sharding(mesh)
    repl = meshlib.replicated(mesh)
    samp_s = meshlib.samples_sharding(mesh)
    samples_shardings = R.SamplesDevice(
        positions=samp_s, normals=samp_s, uvs=samp_s, material_ids=samp_s)
    # prefix-pytree sharding: `repl` broadcasts over every MaterialTable
    # leaf, including the optional texture atlas
    mats_shardings = repl

    def loss_fn(params, origins, dirs, cam_pos, samples, mats, target):
        mats2 = dataclasses.replace(mats, albedo=params["albedo"])
        voxels = R.build_voxel_state(
            cfg, samples, mats2, light_color=params["light_color"])
        img = R.render_rays(cfg, ds, voxels, mats2, origins, dirs, cam_pos,
                            chunk_size=chunk_size)
        return jnp.mean((img - target) ** 2)

    def step(params, opt_state, origins, dirs, cam_pos, samples, mats,
             target):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, origins, dirs, cam_pos, samples, mats, target)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        import optax
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(
        step,
        in_shardings=(repl, repl, rays_s, rays_s, repl, samples_shardings,
                      mats_shardings, rays_s),
        out_shardings=(repl, repl, repl),
    )

"""Sharded == replicated tests on the 8-virtual-device CPU mesh
(SURVEY.md §4 'Distributed')."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from vct_tpu.config import preset, GridConfig
from vct_tpu.core import camera as cameralib
from vct_tpu.parallel import mesh as meshlib
from vct_tpu.parallel import tile_dp
from vct_tpu.render import renderer as R
from vct_tpu.scene import cornell_box



import pytest as _pytest
pytestmark = _pytest.mark.slow   # heavy integration file: excluded from the fast lane (pytest -m "not slow")

def small_cfg():
    cfg = preset("cornell64_full")
    return dataclasses.replace(
        cfg,
        grid=GridConfig(dim=16, world_size=150.0),
        render=dataclasses.replace(cfg.render, width=32, height=32),
    )


@pytest.fixture(scope="module")
def setup():
    cfg = small_cfg()
    scene = cornell_box(size=100.0)
    camera = cameralib.Camera(position=(0.0, 0.0, 140.0))
    ds, mats, samples = R.prepare_scene(cfg, scene)
    origins, dirs = cameralib.primary_rays(camera, 32, 32)
    cam_pos = jnp.asarray(camera.position, jnp.float32)
    return cfg, ds, mats, samples, origins, dirs, cam_pos


pad_samples = tile_dp.pad_samples


def test_mesh_shapes():
    m = meshlib.make_mesh()
    assert m.devices.size == 8
    m2 = meshlib.make_mesh(n_data=4, n_model=2)
    assert m2.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        meshlib.make_mesh(n_data=16, n_model=1)


def test_sharded_render_matches_replicated(setup):
    cfg, ds, mats, samples, origins, dirs, cam_pos = setup
    mesh = meshlib.make_mesh(n_data=4, n_model=2)
    samples_p = pad_samples(samples, 2)

    fn = tile_dp.sharded_render_fn(cfg, ds, mesh, chunk_size=256)
    img_sharded = fn(origins, dirs, cam_pos, samples_p, mats)

    voxels = R.build_voxel_state(cfg, samples, mats)
    img_ref = R.render_rays(cfg, ds, voxels, mats, origins, dirs, cam_pos,
                            chunk_size=256)
    np.testing.assert_allclose(
        np.asarray(img_sharded), np.asarray(img_ref), rtol=2e-4, atol=2e-5)


def test_shardmap_camera_matches_replicated(setup):
    """The collective-free shard_map camera pass (the four-card frame's
    production path) == the replicated render."""
    cfg, ds, mats, samples, origins, dirs, cam_pos = setup
    mesh = meshlib.make_mesh(n_data=4, n_model=2)
    voxels = R.build_voxel_state(cfg, samples, mats)

    fn = tile_dp.shardmap_camera_fn(cfg, ds, mesh, chunk_size=256)
    img_sharded = fn(origins, dirs, cam_pos, voxels, mats)
    # zero collectives in the partitioned program — the property that
    # fixed the r4 n=2 weak-overhead loss (SCALING_ATTRIB_r05.json)
    txt = fn.lower(origins, dirs, cam_pos, voxels, mats).compile().as_text()
    for op in ("all-gather(", "all-reduce(", "collective-permute("):
        assert op not in txt, op

    img_ref = R.render_rays(cfg, ds, voxels, mats, origins, dirs, cam_pos,
                            chunk_size=256)
    np.testing.assert_allclose(
        np.asarray(img_sharded), np.asarray(img_ref), rtol=2e-4, atol=2e-5)


def test_out_of_grid_padding_is_noop(setup):
    cfg, ds, mats, samples, origins, dirs, cam_pos = setup
    v1 = R.build_voxel_state(cfg, samples, mats)
    v2 = R.build_voxel_state(cfg, pad_samples(samples, 64), mats)
    np.testing.assert_allclose(np.asarray(v1.radiance_mips[0]),
                               np.asarray(v2.radiance_mips[0]),
                               rtol=1e-5, atol=1e-6)


def test_sharded_train_step_runs_and_descends(setup):
    cfg, ds, mats, samples, origins, dirs, cam_pos = setup
    mesh = meshlib.make_mesh(n_data=8, n_model=1)
    opt = optax.adam(5e-2)
    step = tile_dp.sharded_train_step_fn(cfg, ds, mesh, opt, chunk_size=256)

    voxels = R.build_voxel_state(cfg, samples, mats)
    target = R.render_rays(cfg, ds, voxels, mats, origins, dirs, cam_pos,
                           chunk_size=256)

    # perturb albedo and recover via gradient steps
    params = {"albedo": mats.albedo * 0.5 + 0.2,
              "light_color": jnp.ones(3) * 0.7}
    opt_state = opt.init(params)
    losses = []
    for _ in range(5):
        params, opt_state, loss = step(
            params, opt_state, origins, dirs, cam_pos, samples, mats, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()

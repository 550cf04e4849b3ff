"""End-to-end GPU camera pass (render/fast.py, kernel in interpret mode)
vs renderer.render_rays at the same field-mode config — the two shade with
the same XLA code, so images agree except where the binned and brute-force
raycasts resolve a shared-edge tie differently."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from vct_tpu.config import preset
from vct_tpu.core import camera as cameralib
from vct_tpu.render import fast as F
from vct_tpu.render import renderer as R
from vct_tpu.scene.atrium import atrium
from vct_tpu.scene.cornell import cornell_box


def _cfg(dim, w, h, spec=True):
    cfg = preset("sponza256")
    return dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, dim=dim, compute="float32"),
        cones=dataclasses.replace(cfg.cones, trace_specular=spec,
                                  field_dim=dim),
        render=dataclasses.replace(cfg.render, width=w, height=h),
    )


@pytest.fixture(scope="module")
def cornell_setup():
    cfg = _cfg(32, 64, 48)
    scene = cornell_box(size=100.0)
    camera = cameralib.Camera(position=(3.0, 2.0, 40.0))
    ds, mats, samples = R.prepare_scene(cfg, scene)
    voxels = R.build_voxel_state_staged(cfg, samples, mats)
    origins, dirs = cameralib.primary_rays(
        camera, cfg.render.width, cfg.render.height)
    cam = jnp.asarray(camera.position, jnp.float32)
    return cfg, ds, mats, voxels, origins, dirs, cam


class TestFastPath:
    def test_matches_reference_path_cornell(self, cornell_setup):
        cfg, ds, mats, voxels, origins, dirs, cam = cornell_setup
        ref = R.render_rays(cfg, ds, voxels, mats, origins, dirs, cam,
                            chunk_size=1024)
        out = F.render_frame(cfg, ds, voxels, mats, origins, dirs, cam,
                             interpret=True)
        assert out.shape == ref.shape
        ref = np.asarray(ref)
        out = np.asarray(out)
        assert np.isfinite(out).all()
        err = np.abs(out - ref)
        assert err.mean() < 1e-4, err.mean()
        assert np.percentile(err, 99) < 1e-4, np.percentile(err, 99)

    def test_textured_scene_runs(self):
        cfg = _cfg(32, 96, 64)
        scene = atrium()
        camera = cameralib.Camera(position=(48.0, -10.0, 0.0), yaw=180.0)
        ds, mats, samples = R.prepare_scene(cfg, scene)
        assert mats.atlas is not None
        voxels = R.build_voxel_state_staged(cfg, samples, mats)
        origins, dirs = cameralib.primary_rays(
            camera, cfg.render.width, cfg.render.height)
        cam = jnp.asarray(camera.position, jnp.float32)
        ref = R.render_rays(cfg, ds, voxels, mats, origins, dirs, cam,
                            chunk_size=512)
        out = F.render_frame(cfg, ds, voxels, mats, origins, dirs, cam,
                             interpret=True)
        out = np.asarray(out)
        ref = np.asarray(ref)
        assert np.isfinite(out).all()
        err = np.abs(out - ref)
        assert err.mean() < 1e-3, err.mean()
        assert (err.max(axis=-1) > 1e-3).mean() < 0.01

    def test_no_specular_config(self, cornell_setup):
        cfg, ds, mats, voxels, origins, dirs, cam = cornell_setup
        cfg2 = dataclasses.replace(
            cfg, cones=dataclasses.replace(cfg.cones, trace_specular=False))
        # rebuild voxels without the specular field
        scene = cornell_box(size=100.0)
        ds2, mats2, samples = R.prepare_scene(cfg2, scene)
        voxels2 = R.build_voxel_state_staged(cfg2, samples, mats2)
        out = F.render_frame(cfg2, ds2, voxels2, mats2, origins, dirs, cam,
                             interpret=True)
        ref = R.render_rays(cfg2, ds2, voxels2, mats2, origins, dirs, cam,
                            chunk_size=1024)
        err = np.abs(np.asarray(out) - np.asarray(ref))
        assert err.mean() < 1e-4, err.mean()

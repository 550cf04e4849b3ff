"""The binned Triton raycast and the GPU camera pass compiled for the card
at real frame widths (the CPU suite runs the same kernel in interpret
mode).  Marked `gpu`; they skip without one:

    VCT_TEST_GPU=1 python -m pytest -m gpu -n 0 tests/
"""

import jax.numpy as jnp
import numpy as np
import pytest

from vct_tpu.config import preset
from vct_tpu.core import camera as cameralib
from vct_tpu.ops import binrast_pallas as BR
from vct_tpu.render import fast as F
from vct_tpu.render import gbuffer as GB
from vct_tpu.render import renderer as R
from vct_tpu.scene.atrium import atrium
from vct_tpu.scene.cornell import cornell_box

pytestmark = pytest.mark.gpu

CAMERA = cameralib.Camera(position=(48.0, -10.0, 0.0), yaw=180.0)


def _hits(ds, width, height):
    """(binned (t, tri), brute-force (t, tri)) over a whole frame."""
    origins, dirs = cameralib.primary_rays(CAMERA, width, height)
    origin = origins.reshape(-1, 3)[0]
    hp = -(-height // BR.STRIP_H) * BR.STRIP_H
    wp = -(-width // BR.STRIP_W) * BR.STRIP_W
    dimg = jnp.pad(dirs, ((0, hp - height), (0, wp - width), (0, 0)),
                   mode="edge")
    d = BR.strip_order(dimg)
    pc = GB.pinhole_constants(ds, origin)
    bins = BR.bin_scene(ds, pc, origin, d, dimg)
    t, tri = BR.raycast_binned(bins, d, jnp.zeros((d.shape[0],)))
    t_b, tri_b = GB.pinhole_hits(ds, origin, d)
    return ((np.asarray(t), np.asarray(tri)),
            (np.asarray(t_b), np.asarray(tri_b)))


@pytest.mark.parametrize("width,height", [(1920, 1080), (1280, 720),
                                          (333, 77)])
def test_kernel_matches_brute_force(gpu, width, height):
    ds = GB.DeviceScene.from_scene(atrium())
    (t, tri), (t_b, tri_b) = _hits(ds, width, height)
    hit, hit_b = np.isfinite(t), np.isfinite(t_b)
    assert np.mean(hit == hit_b) >= 0.9999
    both = hit & hit_b
    same = np.abs(t[both] - t_b[both]) <= 1e-4 * t_b[both]
    same |= tri[both] == tri_b[both]
    # shared-edge cracks (chip_smoke.RAYCAST_DISAGREE)
    assert np.mean(~same) <= 1e-4


def test_camera_pass_matches_render_rays(gpu):
    cfg = preset("cornell64_full")
    camera = cameralib.Camera(position=(3.0, 2.0, 140.0))
    ds, mats, samples = R.prepare_scene(cfg, cornell_box(size=100.0))
    voxels = R.build_voxel_state_staged(cfg, samples, mats)
    origins, dirs = cameralib.primary_rays(camera, 512, 512)
    cam = jnp.asarray(camera.position, jnp.float32)
    out = np.asarray(F.render_frame(cfg, ds, voxels, mats, origins, dirs,
                                    cam))
    ref = np.asarray(R.render_rays(cfg, ds, voxels, mats, origins, dirs,
                                   cam, chunk_size=4096))
    err = np.abs(out - ref).max(axis=-1)
    assert (err > 1e-4).mean() <= 1e-4, (err > 1e-4).mean()

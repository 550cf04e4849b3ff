"""Binning plumbing of the camera pass (ops/binrast_pallas): strip order,
segment tables, and the G-buffer rebuilt from kernel hits."""

import jax.numpy as jnp
import numpy as np
import pytest

from vct_tpu.core import camera as cameralib
from vct_tpu.ops import binrast_pallas as BR
from vct_tpu.render import gbuffer as GB
from vct_tpu.scene.atrium import atrium


@pytest.mark.parametrize("hp,wp", [(16, 64), (32, 128), (48, 192)])
def test_strip_order_roundtrip(hp, wp):
    img = jnp.arange(hp * wp * 3, dtype=jnp.float32).reshape(hp, wp, 3)
    flat = BR.strip_order(img)
    assert flat.shape == (hp * wp, 3)
    # each strip's rays are contiguous: strip 0 is rows 0:16, cols 0:64
    np.testing.assert_array_equal(
        np.sort(np.asarray(flat[:BR.STRIPE, 0])),
        np.sort(np.asarray(img[:16, :64, 0]).reshape(-1)))
    np.testing.assert_array_equal(np.asarray(BR.strip_unorder(flat, hp, wp)),
                                  np.asarray(img))


CAMERAS = [
    cameralib.Camera(position=(48.0, -10.0, 0.0), yaw=180.0, pitch=10.0),
    cameralib.Camera(position=(0.0, 0.0, 0.0), yaw=45.0, pitch=-20.0),
    cameralib.Camera(position=(0.0, 10.0, 160.0)),
]


@pytest.fixture(scope="module")
def ds():
    return GB.DeviceScene.from_scene(atrium())


@pytest.mark.parametrize("cam", range(len(CAMERAS)))
def test_segment_tables_in_bounds(ds, cam):
    """Every strip's segments lie inside the table, start SLICE-aligned,
    and every table row names a real triangle."""
    origins, dirs = cameralib.primary_rays(CAMERAS[cam], 128, 32)
    origin = origins.reshape(-1, 3)[0]
    d = BR.strip_order(dirs)
    bins = BR.bin_scene(ds, GB.pinhole_constants(ds, origin), origin, d,
                        dirs)
    scal = np.asarray(bins.scal)
    npr = bins.table.shape[1]
    assert scal.shape == (4, d.shape[0] // BR.STRIPE)
    assert bins.table.shape == (BR.NROWS, npr) and bins.tri.shape == (npr,)
    assert (scal[[0, 2]] % BR.SLICE == 0).all()
    assert (scal[0] + scal[1] * BR.SLICE <= npr).all()
    assert (scal[2] + scal[3] * BR.SLICE <= npr).all()
    tri = np.asarray(bins.tri)
    assert tri.min() >= 0 and tri.max() < ds.v0.shape[0]
    # the table columns are the pinhole constants of those triangles
    pc = GB.pinhole_constants(ds, origin)
    np.testing.assert_array_equal(np.asarray(bins.table[9]),
                                  np.asarray(pc.k)[tri])


def test_hits_to_gbuffer_matches_general_raycast(ds):
    """The G-buffer rebuilt from (t, tri) equals the general
    Moller-Trumbore path's on the same rays."""
    origins, dirs = cameralib.primary_rays(CAMERAS[0], 32, 16)
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    pc = GB.pinhole_constants(ds, o[0])
    t, tri = GB.intersect_chunk_pinhole(d, pc)
    g = GB.hits_to_gbuffer(ds, pc, o[0], d, t, tri)
    ref = GB.raycast_chunk(ds, o, d)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(g.hit), hit)
    for name in ("position", "normal", "uv"):
        np.testing.assert_allclose(np.asarray(getattr(g, name))[hit],
                                   np.asarray(getattr(ref, name))[hit],
                                   rtol=1e-4, atol=1e-4, err_msg=name)

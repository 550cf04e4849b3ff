"""Binned Triton raycast (render/fast.raycast_image, interpret mode) vs
the XLA pinhole brute force: same hits, same t, same interpolated
G-buffer attributes."""

import numpy as np
import pytest

from vct_tpu.core import camera as cameralib
from vct_tpu.render import fast as F
from vct_tpu.render import gbuffer as GB
from vct_tpu.scene.atrium import atrium
from vct_tpu.scene.cornell import cornell_box


@pytest.fixture(scope="module")
def setup():
    scene = atrium()
    ds = GB.DeviceScene.from_scene(scene)
    cam = cameralib.Camera(position=(48.0, -10.0, 0.0), yaw=180.0)
    origins, dirs = cameralib.primary_rays(cam, 64, 32)
    return ds, origins, dirs


def _both(ds, origins, dirs):
    """(kernel G-buffer, brute-force G-buffer), flat over pixels."""
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    pc = GB.pinhole_constants(ds, o[0])
    t, tri = F.raycast_image(ds, origins, dirs, interpret=True)
    out = GB.hits_to_gbuffer(ds, pc, o[0], d, t.reshape(-1), tri.reshape(-1))
    ref = GB.raycast_chunk_pinhole(ds, pc, o[0], d)
    return out, ref


class TestRaycastPallas:
    def test_matches_xla_pinhole(self, setup):
        out, ref = _both(*setup)
        hit = np.asarray(ref.hit)
        np.testing.assert_array_equal(hit, np.asarray(out.hit))
        assert hit.any() and not hit.all()
        np.testing.assert_allclose(
            np.asarray(out.t)[hit], np.asarray(ref.t)[hit],
            rtol=1e-5, atol=1e-5)
        for name in ("position", "normal", "geo_normal", "tangent",
                     "bitangent", "uv"):
            np.testing.assert_allclose(
                np.asarray(getattr(out, name))[hit],
                np.asarray(getattr(ref, name))[hit],
                rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(out.material)[hit], np.asarray(ref.material)[hit])

    def test_nonmultiple_ray_count(self, setup):
        """Frames that don't divide the 16x64 strip are padded and
        cropped."""
        ds, origins, dirs = setup
        out, ref = _both(ds, origins[:17, :45], dirs[:17, :45])
        assert out.hit.shape == (17 * 45,)
        np.testing.assert_array_equal(np.asarray(ref.hit),
                                      np.asarray(out.hit))
        hit = np.asarray(ref.hit)
        np.testing.assert_allclose(
            np.asarray(out.t)[hit], np.asarray(ref.t)[hit],
            rtol=1e-5, atol=1e-5)

    def test_cornell_interior(self):
        """Every ray from inside the closed box must hit; positions match."""
        scene = cornell_box(size=100.0)
        ds = GB.DeviceScene.from_scene(scene)
        # slightly off-axis: a perfectly centered camera sends corner rays
        # exactly through box edges, where u/v >= 0 resolves differently
        # under different (equally valid) f32 accumulation orders
        cam = cameralib.Camera(position=(3.0, 2.0, 40.0))
        origins, dirs = cameralib.primary_rays(cam, 32, 16)
        out, ref = _both(ds, origins, dirs)
        np.testing.assert_array_equal(np.asarray(ref.hit),
                                      np.asarray(out.hit))
        hit = np.asarray(ref.hit)
        assert hit.mean() > 0.9
        np.testing.assert_allclose(
            np.asarray(out.position)[hit], np.asarray(ref.position)[hit],
            rtol=1e-4, atol=1e-3)

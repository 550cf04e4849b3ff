"""Binned raster-style raycast (ops/binrast_pallas) vs the XLA brute force:
hit/depth parity, conservativeness across cameras (including cameras
embedded in the scene, which exercise near-plane clipping and the
per-column wide-triangle tier), and the camera-pass integration.

All kernel runs use interpret=True (CPU); tests/test_gpu.py compiles the
real thing on a GPU.
"""

import dataclasses

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
from vct_tpu.scene.mesh import subdivide_scene

W, H = 128, 64          # wp=128 -> 2 strip columns, hp=64 -> 4 rows


@pytest.fixture(scope="module")
def scene_small():
    cfg = preset("sponza256")
    ds, mats, _ = R.prepare_scene(cfg, atrium())
    return ds, mats


@pytest.fixture(scope="module")
def scene_big():
    cfg = preset("sponza256")
    ds, mats, _ = R.prepare_scene(cfg, subdivide_scene(atrium(), 1))
    return ds, mats


def _rays(camera):
    origins, dirs = cameralib.primary_rays(camera, W, H)
    return origins.reshape(-1, 3)[0], BR.strip_order(dirs), dirs


def _binned(ds, origin, dflat, dimg, bins=None):
    if bins is None:
        pc = GB.pinhole_constants(ds, origin)
        bins = BR.bin_scene(ds, pc, origin, dflat, dimg)
    t, tri = BR.raycast_binned(bins, dflat, jnp.zeros((dflat.shape[0],)),
                               interpret=True)
    return np.asarray(t), np.asarray(tri)


def _brute(ds, origin, dflat):
    pc = GB.pinhole_constants(ds, origin)
    t, tri = GB.intersect_chunk_pinhole(dflat, pc)
    return np.asarray(t), np.asarray(tri)


def _assert_same_hits(a, b, min_agree=0.999):
    """Equal hit masks; where both hit, the same t (or, for shared-edge
    cracks where two roundings disagree, at most 1 - min_agree of the
    pixels on another surface)."""
    (t, tri), (t_b, tri_b) = a, b
    hit, hit_b = np.isfinite(t), np.isfinite(t_b)
    assert hit.any()
    np.testing.assert_array_equal(hit, hit_b)
    both = hit & hit_b
    same = np.abs(t[both] - t_b[both]) <= 1e-4 * t_b[both]
    assert same.mean() >= min_agree, same.mean()
    # equal t: the same winner up to exact ties
    assert (tri[both][same] == tri_b[both][same]).mean() > 0.99


CAMERAS = [
    cameralib.Camera(position=(48.0, -10.0, 0.0), yaw=180.0),
    cameralib.Camera(position=(0.0, 0.0, 0.0), yaw=45.0, pitch=-20.0),
    cameralib.Camera(position=(-30.0, 5.0, 10.0), yaw=10.0, pitch=30.0),
]


@pytest.mark.parametrize("cam", range(len(CAMERAS)))
def test_binned_matches_whole_table(scene_small, cam):
    """Hit/t parity against the brute force over the whole table."""
    ds, _ = scene_small
    origin, dflat, dimg = _rays(CAMERAS[cam])
    _assert_same_hits(_binned(ds, origin, dflat, dimg),
                      _brute(ds, origin, dflat))


def test_binned_big_scene(scene_big):
    ds, _ = scene_big
    origin, dflat, dimg = _rays(CAMERAS[0])
    _assert_same_hits(_binned(ds, origin, dflat, dimg),
                      _brute(ds, origin, dflat))


def test_column_tier_within_budget(scene_big):
    """The column tier (near-plane straddlers + wide tris) must fit its
    budget at Sponza scale — overflow beyond it would DROP geometry."""
    ds, _ = scene_big
    origin, dflat, dimg = _rays(CAMERAS[1])   # camera inside the scene
    _, _, n_col = BR.bin_triangles(ds, origin, dflat, dimg)
    _, nb_col = BR._budgets(int(ds.v0.shape[0]))
    assert int(n_col) <= nb_col, (int(n_col), nb_col)


def test_segments_contain_all_covering_triangles(scene_small):
    """Conservativeness at the binning level: every triangle that wins a
    strip's ray under the brute force appears in that strip's segment or
    its column's."""
    ds, _ = scene_small
    origin, dflat, dimg = _rays(CAMERAS[0])
    scal, tri_p, _ = BR.bin_triangles(ds, origin, dflat, dimg)
    scal, tri_p = np.asarray(scal), np.asarray(tri_p)
    t_b, tri_b = _brute(ds, origin, dflat)
    for s in range(scal.shape[1]):
        seg = set(tri_p[scal[0, s]:scal[0, s] + scal[1, s] * BR.SLICE])
        seg |= set(tri_p[scal[2, s]:scal[2, s] + scal[3, s] * BR.SLICE])
        rays = slice(s * BR.STRIPE, (s + 1) * BR.STRIPE)
        winners = set(tri_b[rays][np.isfinite(t_b[rays])].tolist())
        assert winners <= seg, (s, sorted(winners - seg)[:5])


def test_fast_path_uses_binned(scene_big):
    """render_frame (binned kernel) on the subdivided scene matches
    render_rays (brute force) image."""
    cfg = preset("sponza256")
    cfg = dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, dim=32, compute="float32"),
        cones=dataclasses.replace(cfg.cones, field_dim=32),
        render=dataclasses.replace(cfg.render, width=W, height=H))
    dsb, matsb = scene_big
    _, _, samples = R.prepare_scene(cfg, atrium())
    voxels = R.build_voxel_state_staged(cfg, samples, matsb)
    camera = CAMERAS[0]
    origins, dirs = cameralib.primary_rays(camera, W, H)
    cam = jnp.asarray(camera.position, jnp.float32)
    img_b = np.asarray(F.render_frame(cfg, dsb, voxels, matsb, origins,
                                      dirs, cam, interpret=True))
    img_r = np.asarray(R.render_rays(cfg, dsb, voxels, matsb, origins, dirs,
                                     cam, chunk_size=1024))
    # same image up to winner tie-breaks on edge pixels
    err = np.abs(img_b - img_r)
    assert err.mean() < 1e-3, err.mean()
    assert (err.max(axis=-1) > 0.02).mean() < 0.01

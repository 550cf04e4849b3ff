"""Binned raycast properties beyond brute-force parity: culling
conservativeness (a strip's segment vs every triangle), the subdivision
stress fixture (scene/mesh.subdivide_scene), Morton-order invariance and
per-material shininess through the kernel's G-buffer.

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

W, H = 64, 32


@pytest.fixture(scope="module")
def rays():
    camera = cameralib.Camera(position=(48.0, -10.0, 0.0), yaw=180.0)
    return cameralib.primary_rays(camera, W, H)


@pytest.fixture(scope="module")
def scene_small():
    cfg = preset("sponza256")
    ds, mats, _ = R.prepare_scene(cfg, atrium())
    return ds, mats


@pytest.fixture(scope="module")
def scene_big():
    cfg = preset("sponza256")
    ds, mats, _ = R.prepare_scene(cfg, subdivide_scene(atrium(), 2))
    return ds, mats


def _gbuf(ds, origins, dirs):
    t, tri = F.raycast_image(ds, origins, dirs, interpret=True)
    o = origins.reshape(-1, 3)[0]
    return GB.hits_to_gbuffer(ds, GB.pinhole_constants(ds, o), o,
                              dirs.reshape(-1, 3), t.reshape(-1),
                              tri.reshape(-1))


def test_culling_is_conservative(scene_big, rays):
    """Binned segments find the same nearest hit as giving every strip
    the whole triangle table — no winner is ever culled.  The per-(ray,
    triangle) math is the same and ties go to the lowest id, so t and the
    winner are bit-equal."""
    ds, _ = scene_big
    origins, dirs = rays
    origin = origins.reshape(-1, 3)[0]
    d = BR.strip_order(dirs)
    pc = GB.pinhole_constants(ds, origin)
    binned = BR.bin_scene(ds, pc, origin, d, dirs)
    ns = d.shape[0] // BR.STRIPE
    t_real = ds.v0.shape[0]
    nslice = -(-t_real // BR.SLICE)
    assert int(jnp.max(binned.scal[1] + binned.scal[3])) < nslice, (
        "expected some culling")
    tri = jnp.arange(nslice * BR.SLICE, dtype=jnp.int32) % t_real
    tbl = jnp.concatenate([pc.a, pc.b, pc.c, pc.k[:, None]], axis=1)
    scal = jnp.zeros((4, ns), jnp.int32).at[1].set(nslice)
    full = BR.Bins(scal=scal, table=tbl[tri].T, tri=tri)
    tmin = jnp.zeros((d.shape[0],))
    t_c, i_c = BR.raycast_binned(binned, d, tmin, interpret=True)
    t_f, i_f = BR.raycast_binned(full, d, tmin, interpret=True)
    np.testing.assert_array_equal(np.asarray(t_c), np.asarray(t_f))
    np.testing.assert_array_equal(np.asarray(i_c), np.asarray(i_f))


def test_subdivided_scene_matches_original(scene_small, scene_big, rays):
    """subdivide_scene leaves the surfaces identical: hit positions from
    the 16x-triangle scene match the original's to float tolerance."""
    g0 = _gbuf(scene_small[0], *rays)
    g1 = _gbuf(scene_big[0], *rays)
    h0, h1 = np.asarray(g0.hit), np.asarray(g1.hit)
    assert (h0 == h1).mean() > 0.995      # edge rays may flip
    both = h0 & h1
    np.testing.assert_allclose(np.asarray(g1.position)[both],
                               np.asarray(g0.position)[both],
                               rtol=1e-3, atol=1e-2)


def test_morton_sort_preserves_image(rays):
    """DeviceScene triangle reordering changes nothing visible."""
    origins, dirs = rays
    scene = atrium()
    ga = _gbuf(GB.DeviceScene.from_scene(scene, morton_sort=True), *rays)
    gb = _gbuf(GB.DeviceScene.from_scene(scene, morton_sort=False), *rays)
    np.testing.assert_array_equal(np.asarray(ga.hit), np.asarray(gb.hit))
    np.testing.assert_allclose(np.asarray(ga.position),
                               np.asarray(gb.position), rtol=1e-5, atol=1e-5)


def test_per_material_shininess_rides_gbuffer(rays):
    """MTL Ns flows scene -> MaterialTable -> the kernel's G-buffer
    material -> the shading exponent (the reference hardcodes 20 for
    every mesh).  Distinct per-material exponents so the check cannot
    pass on a constant."""
    scene = atrium()
    scene = dataclasses.replace(scene, materials=[
        dataclasses.replace(m, shininess=5.0 + 7.0 * i)
        for i, m in enumerate(scene.materials)])
    ds = GB.DeviceScene.from_scene(scene)
    mats = R.MaterialTable.from_scene(scene)
    g = _gbuf(ds, *rays)
    hit = np.asarray(g.hit)
    mat_ids = np.asarray(g.material)[hit]
    assert len(set(mat_ids.tolist())) > 1     # multiple materials visible
    np.testing.assert_allclose(np.asarray(mats.shininess[g.material])[hit],
                               5.0 + 7.0 * mat_ids, rtol=1e-6)

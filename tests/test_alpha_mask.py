"""Alpha-mask SEE-THROUGH (fs:169-172 `discard`; VERDICT r4 missing #3).

The reference discards fragments whose diffuse-texture alpha < 0.5, so
the depth-tested geometry BEHIND the masked texel renders.  Both camera
passes (render_rays and the binned GPU pass, kernel in interpret mode)
must continue the ray: a masked quad in front of a wall shows the WALL
(not the background) through its masked half.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from vct_tpu.config import preset, GridConfig
from vct_tpu.core import camera as cameralib
from vct_tpu.render import fast as F
from vct_tpu.render import renderer as R
from vct_tpu.scene.mesh import Material, scene_from_arrays


WALL_RGB = (0.9, 0.1, 0.1)
BG = (0.0, 0.0, 1.0)


def masked_scene(mask_value: float = 0.0, second_layer: bool = False):
    """A red wall at z=-20 with a green quad at z=0 whose LEFT half
    (u < 0.5) is alpha-masked; camera on +z looking down -z.
    second_layer adds ANOTHER fully masked quad at z=-10 (stacked masks
    exercise alpha_mask_depth > 1)."""
    def quad(z, x0=-40.0, x1=40.0, y0=-40.0, y1=40.0):
        v = [(x0, y0, z), (x1, y0, z), (x1, y1, z), (x0, y1, z)]
        uv = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
        tris = [(0, 1, 2), (0, 2, 3)]
        return v, uv, tris

    verts, uvs, tris, mats_idx = [], [], [], []

    def add(z, mat):
        v, uv, t = quad(z)
        base = len(verts)
        verts.extend(v)
        uvs.extend(uv)
        tris.extend([(a + base, b + base, c + base) for a, b, c in t])
        mats_idx.extend([mat, mat])

    add(-20.0, 0)                       # wall (red)
    add(0.0, 1)                         # masked quad (green, left half cut)
    if second_layer:
        add(-10.0, 2)                   # fully masked mid quad

    # mask texture: alpha 0 on the left half (u < 0.5), 1 on the right
    m = np.ones((8, 8), np.float32)
    m[:, :4] = mask_value
    # wall carries a (fully opaque) albedo texture so the atlas exists
    wall_tex = np.ones((4, 4, 3), np.float32) * np.asarray(WALL_RGB)
    materials = [
        Material(name="wall", albedo=(*WALL_RGB, 1.0),
                 albedo_texture=wall_tex),
        Material(name="masked", albedo=(0.1, 0.9, 0.1, 1.0),
                 mask_texture=m),
        Material(name="gone", albedo=(0.1, 0.1, 0.9, 1.0),
                 mask_texture=np.zeros((4, 4), np.float32)),
    ]
    return scene_from_arrays(
        np.asarray(verts, np.float32), np.asarray(tris, np.int32),
        uvs=np.asarray(uvs, np.float32),
        tri_material=np.asarray(mats_idx, np.int32), materials=materials)


def small_cfg():
    cfg = preset("sponza256")          # the bench config family
    return dataclasses.replace(
        cfg,
        grid=GridConfig(dim=16, world_size=150.0),
        render=dataclasses.replace(cfg.render, width=64, height=64,
                                   background=BG),
    )


def render_pair(cfg, scene):
    """(oracle image, fast image) at 64x64."""
    camera = cameralib.Camera(position=(0.0, 0.0, 60.0), yaw=-90.0)
    ds, mats, samples = R.prepare_scene(cfg, scene)
    voxels = R.build_voxel_state(cfg, samples, mats)
    origins, dirs = cameralib.primary_rays(camera, 64, 64)
    cam = jnp.asarray(camera.position, jnp.float32)
    img_o = np.asarray(R.render_rays(cfg, ds, voxels, mats, origins, dirs,
                                     cam, chunk_size=1024))
    img_f = np.asarray(F.render_frame(cfg, ds, voxels, mats, origins, dirs,
                                      cam, interpret=True))
    return img_o, img_f


def _assert_wall_shows(img, masked_col, kept_col):
    """Masked-half pixels show the (red-dominant) wall, not the blue
    background; kept-half pixels show the green quad."""
    mpx = img[32, masked_col]
    kpx = img[32, kept_col]
    assert mpx[0] > mpx[2] + 0.05, f"masked px shows background: {mpx}"
    assert kpx[1] > kpx[0], f"kept px lost the front quad: {kpx}"


def test_masked_half_shows_wall_oracle_and_fast():
    cfg = small_cfg()
    img_o, img_f = render_pair(cfg, masked_scene())
    # camera yaw -90 looks down -z with +x to the LEFT of the image?  Use
    # both candidate columns: one half must be wall-red, the other green.
    left, right = 16, 48
    lo, ro = img_o[32, left], img_o[32, right]
    masked_col, kept_col = (left, right) if lo[0] > lo[1] else (right, left)
    _assert_wall_shows(img_o, masked_col, kept_col)
    _assert_wall_shows(img_f, masked_col, kept_col)
    # no background leaks anywhere inside the quad's footprint
    inner_o = img_o[8:56, 8:56]
    inner_f = img_f[8:56, 8:56]
    assert not np.any(inner_o[..., 2] > 0.9), "oracle leaked background"
    assert not np.any(inner_f[..., 2] > 0.9), "fast path leaked background"


def test_stacked_masks_need_depth_2():
    """Two stacked masked layers resolve with depth=2 but not depth=1."""
    cfg = small_cfg()
    scene = masked_scene(second_layer=True)
    img_o, img_f = render_pair(cfg, scene)
    masked = img_o[32, 16], img_o[32, 48]
    # one of the halves passes through BOTH masked layers to the wall
    reds = [float(px[0] > px[1] and px[0] > px[2]) for px in masked]
    assert sum(reds) >= 1.0, masked
    cfg1 = dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, alpha_mask_depth=1))
    img1, _ = render_pair(cfg1, scene)
    # with depth=1 the second masked layer cannot resolve: the mid quad's
    # own masked hit is found, sampled as masked, and painted background
    col = 16 if reds[0] else 48
    assert img1[32, col][2] > 0.8, img1[32, col]


def test_depth_zero_keeps_old_behavior():
    cfg = dataclasses.replace(
        small_cfg(),
        render=dataclasses.replace(small_cfg().render, alpha_mask_depth=0))
    img_o, img_f = render_pair(cfg, masked_scene())
    blue_o = (img_o[32, :, 2] > 0.9).sum()
    blue_f = (img_f[32, :, 2] > 0.9).sum()
    assert blue_o > 10 and blue_f > 10   # masked half -> background

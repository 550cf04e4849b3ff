"""The GPU camera pass on the CPU: the binned Triton kernel in interpret
mode against the brute force across scenes and cameras, ragged frames,
per-pixel tmin, the camera pass against render_rays across configs and
under jax.grad, and the backend dispatch, compile-cache and bench
peak-table plumbing around it."""

import dataclasses
import os
import subprocess
import sys

import jax
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
from vct_tpu.scene.mesh import subdivide_scene
from vct_tpu.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCENES = {
    "cornell": lambda: cornell_box(size=100.0),
    "atrium": atrium,
    "atrium_subdiv": lambda: subdivide_scene(atrium(), 1),
}
# outside the geometry looking in; inside it; and on a surface's plane so
# triangles straddle the near plane (z = ZEPS clipping)
CAMERAS = {
    "cornell": {
        "outside": cameralib.Camera(position=(3.0, 2.0, 140.0)),
        "inside": cameralib.Camera(position=(3.0, 2.0, 20.0), yaw=-60.0),
        "straddle": cameralib.Camera(position=(49.9, 1.0, 0.0), yaw=200.0,
                                     pitch=5.0),
    },
    "atrium": {
        "outside": cameralib.Camera(position=(0.0, 10.0, 160.0)),
        "inside": cameralib.Camera(position=(48.0, -10.0, 0.0), yaw=180.0,
                                   pitch=10.0),
        "straddle": cameralib.Camera(position=(0.0, -10.0, 0.5), yaw=30.0),
    },
}


@pytest.fixture(scope="module")
def device_scenes():
    return {k: GB.DeviceScene.from_scene(f()) for k, f in SCENES.items()}


def _brute_image(ds, origins, dirs):
    o = origins.reshape(-1, 3)[0]
    t, tri = GB.intersect_chunk_pinhole(dirs.reshape(-1, 3),
                                         GB.pinhole_constants(ds, o))
    return np.asarray(t), np.asarray(tri)


def _kernel_image(ds, origins, dirs):
    t, tri = F.raycast_image(ds, origins, dirs, interpret=True)
    return np.asarray(t).reshape(-1), np.asarray(tri).reshape(-1)


def _agree(a, b):
    """Share of pixels on the same surface (hit masks equal; where both
    hit, equal t to 1e-4 or the same triangle)."""
    (t, tri), (t_b, tri_b) = a, b
    hit, hit_b = np.isfinite(t), np.isfinite(t_b)
    same = hit == hit_b
    both = hit & hit_b
    near = np.abs(np.where(both, t, 0) - np.where(both, t_b, 0)) <= (
        1e-4 * np.where(both, t_b, 0))
    return np.mean(same & (~both | near | (tri == tri_b))), hit_b.mean()


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("view", ["outside", "inside", "straddle"])
def test_kernel_matches_brute_force(device_scenes, scene, view):
    ds = device_scenes[scene]
    cam = CAMERAS["cornell" if scene == "cornell" else "atrium"][view]
    origins, dirs = cameralib.primary_rays(cam, 64, 48)
    agree, hit = _agree(_kernel_image(ds, origins, dirs),
                        _brute_image(ds, origins, dirs))
    assert hit > 0.2, hit
    # shared-edge cracks only (chip_smoke.RAYCAST_DISAGREE at 1080p)
    assert agree >= 0.999, agree


@pytest.mark.parametrize("width,height", [(1, 1), (17, 5), (64, 16),
                                          (65, 17), (130, 33)])
def test_ragged_frames(device_scenes, width, height):
    ds = device_scenes["atrium"]
    cam = CAMERAS["atrium"]["inside"]
    origins, dirs = cameralib.primary_rays(cam, width, height)
    t, tri = F.raycast_image(ds, origins, dirs, interpret=True)
    assert t.shape == (height, width) and tri.shape == (height, width)
    hits = (np.asarray(t).reshape(-1), np.asarray(tri).reshape(-1))
    agree, _ = _agree(hits, _brute_image(ds, origins, dirs))
    assert agree >= 0.999, agree


@pytest.mark.parametrize("kind", ["zero", "past_first_hit", "retired"])
def test_per_pixel_tmin(device_scenes, kind):
    """The kernel's per-ray tmin equals intersect_chunk_pinhole(tmin=),
    and tmin = +inf retires a ray (no hit)."""
    ds = device_scenes["atrium"]
    cam = CAMERAS["atrium"]["inside"]
    origins, dirs = cameralib.primary_rays(cam, 64, 16)
    origin = origins.reshape(-1, 3)[0]
    d = BR.strip_order(dirs)
    pc = GB.pinhole_constants(ds, origin)
    bins = BR.bin_scene(ds, pc, origin, d, dirs)
    t0, _ = GB.intersect_chunk_pinhole(d, pc)
    n = d.shape[0]
    if kind == "zero":
        tmin = jnp.zeros((n,))
    elif kind == "past_first_hit":
        tmin = jnp.where(jnp.isfinite(t0), t0 * (1 + 1e-5) + 1e-4, -1.0)
    else:
        tmin = jnp.where(jnp.arange(n) % 3 == 0, jnp.inf, 0.0)
    t, tri = BR.raycast_binned(bins, d, tmin, interpret=True)
    t_b, tri_b = GB.intersect_chunk_pinhole(d, pc, tmin=tmin)
    agree, _ = _agree((np.asarray(t), np.asarray(tri)),
                      (np.asarray(t_b), np.asarray(tri_b)))
    assert agree >= 0.999, agree
    if kind == "retired":
        assert not np.isfinite(np.asarray(t)[::3]).any()
    if kind == "past_first_hit":
        hit0 = np.isfinite(np.asarray(t0))
        assert (np.asarray(t)[hit0] > np.asarray(t0)[hit0]).all()


def _small(name, **grid):
    cfg = preset(name)
    return dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, dim=16, **grid),
        cones=dataclasses.replace(cfg.cones, field_dim=16),
        shadow=dataclasses.replace(cfg.shadow, map_size=256),
        render=dataclasses.replace(cfg.render, width=48, height=32))


CONFIGS = {
    "flat": (lambda: _small("cornell64_full"), "cornell"),
    "textured_alpha": (lambda: _small("sponza256", compute="float32"),
                       "atrium"),
    "no_specular": (lambda: _small("cornell64"), "cornell"),
    "anisotropic": (lambda: _small("aniso128"), "atrium"),
    "shadow_map": (lambda: _small("reference"), "atrium"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_camera_pass_matches_render_rays(name):
    make_cfg, scene = CONFIGS[name]
    cfg = make_cfg()
    cam = CAMERAS["cornell" if scene == "cornell" else "atrium"]["inside"]
    ds, mats, samples = R.prepare_scene(cfg, SCENES[scene]())
    voxels = R.build_voxel_state_staged(cfg, samples, mats)
    origins, dirs = cameralib.primary_rays(cam, 48, 32)
    cp = jnp.asarray(cam.position, jnp.float32)
    out = np.asarray(F.render_frame(cfg, ds, voxels, mats, origins, dirs, cp,
                                    chunk_size=512, interpret=True))
    ref = np.asarray(R.render_rays(cfg, ds, voxels, mats, origins, dirs, cp,
                                   chunk_size=512))
    assert np.isfinite(out).all() and out.shape == ref.shape
    err = np.abs(out - ref).max(axis=-1)
    assert (err > 1e-4).mean() <= 0.002, (err > 1e-4).mean()


@pytest.mark.parametrize("param", ["albedo", "light"])
def test_gradients_match_render_rays(param):
    """jax.grad through the camera pass (the raycast carries no gradient;
    shading is shared XLA code) equals the gradient through render_rays."""
    cfg = _small("cornell64_full")
    cam = CAMERAS["cornell"]["outside"]
    ds, mats, samples = R.prepare_scene(cfg, cornell_box(size=100.0))
    origins, dirs = cameralib.primary_rays(cam, 32, 24)
    cp = jnp.asarray(cam.position, jnp.float32)

    def loss(p, frame):
        m = (dataclasses.replace(mats, albedo=p) if param == "albedo"
             else mats)
        lc = p if param == "light" else None
        voxels = R.build_voxel_state(cfg, samples, m, light_color=lc)
        return jnp.mean(frame(cfg, ds, voxels, m, origins, dirs, cp) ** 2)

    p0 = mats.albedo if param == "albedo" else jnp.ones(3) * 0.9
    g_f = jax.grad(loss)(p0, lambda *a: F.render_frame(
        *a, chunk_size=512, interpret=True))
    g_r = jax.grad(loss)(p0, lambda *a: R.render_rays(*a, chunk_size=512))
    g_f, g_r = np.asarray(g_f), np.asarray(g_r)
    assert np.abs(g_r).max() > 0
    np.testing.assert_allclose(g_f, g_r, rtol=1e-4,
                               atol=1e-6 * np.abs(g_r).max())


@pytest.mark.parametrize("backend", ["gpu", "cpu", "rocm"])
def test_backend_dispatch(monkeypatch, backend):
    """render_camera_pass: gpu -> the binned pass, cpu -> render_rays,
    anything else raises."""
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(F, "render_frame",
                        lambda *a, **k: calls.append("binned"))
    monkeypatch.setattr(R, "render_rays",
                        lambda *a, **k: calls.append("render_rays"))
    args = (preset("cornell64"),) + (None,) * 6
    if backend == "rocm":
        with pytest.raises(NotImplementedError):
            R.render_camera_pass(*args)
        assert calls == []
    else:
        R.render_camera_pass(*args)
        assert calls == ["binned" if backend == "gpu" else "render_rays"]


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "NVIDIA A100"])
def test_bench_peak_table(kind):
    sys.path.insert(0, REPO)
    import bench
    if kind in bench.PEAKS:
        p = bench.peaks(kind)
        assert p["hbm_bytes_per_s"] == 3.35e12
        assert p["bf16_flops_per_s"] == 989e12
    else:
        with pytest.raises(ValueError):
            bench.peaks(kind)


@pytest.mark.parametrize("env", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env):
    """JAX_COMPILATION_CACHE_DIR wins; otherwise <checkout>/.jax_cache."""
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    if env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert profiling.enable_compile_cache() == str(tmp_path)
        assert updates == {}
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
        assert profiling.enable_compile_cache() == want
        assert updates == {"jax_compilation_cache_dir": want}


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_off_gpu(tmp_path, where):
    """chip_smoke.py exits non-zero and prints no "ok" line on the CPU,
    and in a directory that holds nothing else of the repository."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        lone = tmp_path / "chip_smoke.py"
        lone.write_text(open(script).read())
        script = str(lone)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    env.pop("PYTHONPATH", None)
    cp = subprocess.run([sys.executable, script], cwd=str(tmp_path),
                        env=env, capture_output=True, text=True, timeout=300)
    assert cp.returncode != 0
    assert '"ok"' not in cp.stdout

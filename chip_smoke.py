"""Smoke run of the renderer on one GPU, through the entry points a user
calls, at the bench operating point.

  python chip_smoke.py               one card, every phase below
  python chip_smoke.py --four-cards  the four-card path only (needs 4 GPUs)

Phases (one card):
  1. device check: JAX must find a GPU (no CPU fallback);
  2. the gpu-marked tests but the slow lane, in this process;
  3. build: preset("sponza256") on the atrium at 256^3, cold and warm,
     against the same build in float32 at highest matmul precision;
  4. frame: 1920x1080 on the 4-way-subdivided atrium (287,232 triangles)
     through render_camera_pass, cold and warm; the Triton raycast
     against the brute force and the frame against render_rays on a
     strided pixel subset; the Triton call in the compiled frame's HLO;
  5. one frame of every other preset but multihost512;
  6. five Adam steps of the inverse pass with the camera pass and with
     render_rays, and their albedo gradients;
then prints the card and, as the last line, one JSON object with "ok".

With --four-cards: the multihost512 grid (512^3, field cones) built
brick-sharded on a ('data' 2, 'model' 2) mesh against the one-card build,
and the tile-DP 1080p frame over data=4 against the one-card frame.

Any failed phase makes the script exit non-zero without the "ok" line.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402

from vct_tpu.config import preset  # noqa: E402
from vct_tpu.core import camera as cameralib  # noqa: E402
from vct_tpu.render import fast as F  # noqa: E402
from vct_tpu.render import gbuffer as GB  # noqa: E402
from vct_tpu.render import renderer as R  # noqa: E402
from vct_tpu.scene import atrium, cornell_box  # noqa: E402
from vct_tpu.scene.mesh import subdivide_scene  # noqa: E402
from vct_tpu.utils.profiling import enable_compile_cache  # noqa: E402

# bench.py's camera: down the nave, pitched up onto the alpha-masked
# banners
BENCH_CAMERA = cameralib.Camera(**bench.CAMERA)
N_SUBSET = 65536          # pixels compared against the brute force
# bf16 is sponza256's configured march compute: each resample operand is
# rounded to 8 mantissa bits (2^-9 relative) and the marches composite
# tens of such taps with f32 accumulation, so products track the f32
# build to a few 1e-4 RMS; 1e-2 leaves room for 256^3's longer marches
BUILD_REL_RMS = 1e-2
# the camera pass shades with the same XLA code as render_rays, so where
# the two raycasts agree the images may differ only by summation order
FRAME_REL_RMS = 1e-3
# Moller-Trumbore is not watertight: a ray through the shared edge of two
# triangles can pass between them under one rounding and hit under
# another, so a few pixels per 1e4 may see a different surface
RAYCAST_DISAGREE = 1e-4
GRAD_REL = 1e-4


def say(*a):
    print(*a, flush=True)


def rel_rms(x, ref):
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((x - ref) ** 2))
                 / max(np.sqrt(np.mean(ref ** 2)), 1e-12))


def timed(fn):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_devices(count):
    devs = jax.devices()
    say(f"jax.devices(): {devs}")
    say(f"device_kind: {devs[0].device_kind}  platform: {devs[0].platform}")
    check(devs[0].platform == "gpu",
          f"no GPU: JAX runs on {devs[0].platform}")
    check(len(devs) >= count, f"need {count} GPUs, JAX sees {len(devs)}")
    say(f"nvidia-smi: {bench.card_line()}")


def phase_gpu_tests():
    import pytest
    os.environ["VCT_TEST_GPU"] = "1"
    # the slow lane (the 256^3 fidelity gate) is left to its own run
    rc = pytest.main(["-q", "-m", "gpu and not slow", "-n", "0",
                      "-p", "no:cacheprovider", os.path.join(REPO, "tests")])
    check(rc == 0, f"gpu-marked tests: pytest exit code {int(rc)}")


def phase_build(ctx):
    cfg = preset("sponza256")
    ds, mats, samples = R.prepare_scene(cfg, atrium())
    build = R.build_voxel_state_staged
    voxels, cold = timed(lambda: build(cfg, samples, mats))
    _, warm = timed(lambda: build(cfg, samples, mats))
    say(f"build 256^3 bf16: cold {cold:.3f} s (with compile), "
        f"warm {warm * 1e3:.3f} ms; peak_bytes_in_use {peak_bytes()}")
    cfg32 = dataclasses.replace(
        cfg, grid=dataclasses.replace(cfg.grid, compute="float32"))
    with jax.default_matmul_precision("highest"):
        ref = jax.block_until_ready(build(cfg32, samples, mats))
    pairs = {
        "radiance level 0": (voxels.radiance_mips[0], ref.radiance_mips[0]),
        "light volume": (voxels.light_volume, ref.light_volume),
        "diffuse field": (voxels.diffuse_field, ref.diffuse_field),
        "specular field": (voxels.specular_field, ref.specular_field),
    }
    for name, (a, b) in pairs.items():
        e = rel_rms(a, b)
        say(f"  {name}: rel RMS vs f32/highest {e:.3e} "
            f"(bound {BUILD_REL_RMS:.0e}, bf16 compute)")
        check(np.isfinite(e) and e <= BUILD_REL_RMS, f"build {name} {e}")
    del ref
    ctx.update(cfg=cfg, mats=mats, samples=samples, voxels=voxels)


def phase_frame(ctx):
    cfg, mats, voxels = ctx["cfg"], ctx["mats"], ctx["voxels"]
    ds, _, _ = R.prepare_scene(cfg, subdivide_scene(atrium(), 4),
                               samples=ctx["samples"])
    ntri = int(ds.v0.shape[0])
    w, h = cfg.render.width, cfg.render.height
    origins, dirs = cameralib.primary_rays(BENCH_CAMERA, w, h)
    cam = jnp.asarray(BENCH_CAMERA.position, jnp.float32)

    def frame():
        return R.render_camera_pass(cfg, ds, voxels, mats, origins, dirs, cam)

    img, cold = timed(frame)
    _, warm = timed(frame)
    say(f"frame {w}x{h}, {ntri} triangles: cold {cold:.3f} s "
        f"(with compile), warm {warm * 1e3:.3f} ms; "
        f"peak_bytes_in_use {peak_bytes()}")
    img = np.asarray(img)
    check(img.shape == (h, w, 3) and np.isfinite(img).all(), "frame values")

    # kernel proof: the compiled frame calls the Pallas-Triton kernel
    hlo = F.render_frame.lower(cfg, ds, voxels, mats, origins, dirs,
                               cam).compile().as_text()
    targets = [t for t in ("__gpu$xla.gpu.triton", "triton_kernel_call")
               if t in hlo]
    say(f"compiled frame HLO: Triton custom call {targets}, "
        f"kernel name present: {'binned_raycast' in hlo}")
    check(targets, "no Triton custom call in the compiled frame")

    # raycast: Triton kernel vs the brute force on a strided subset
    origin = origins.reshape(-1, 3)[0]
    stride = max(1, (h * w) // N_SUBSET)
    idx = np.arange(0, h * w, stride)
    t_k, tri_k = F.raycast_image(ds, origins, dirs)
    t_k = np.asarray(t_k).reshape(-1)[idx]
    tri_k = np.asarray(tri_k).reshape(-1)[idx]
    d_sub = dirs.reshape(-1, 3)[idx]
    t_b, tri_b = jax.jit(GB.pinhole_hits)(ds, origin, d_sub)
    t_b, tri_b = np.asarray(t_b), np.asarray(tri_b)
    hk, hb = np.isfinite(t_k), np.isfinite(t_b)
    both = hk & hb
    near = np.zeros_like(both)
    near[both] = np.abs(t_k[both] - t_b[both]) <= 1e-4 * t_b[both]
    agree = (hk == hb) & (~both | near | (tri_k == tri_b))
    hit_eq = float(np.mean(hk == hb))
    disagree = float(np.mean(~agree))
    say(f"raycast vs brute force on {idx.size} pixels: hit masks equal "
        f"{hit_eq:.6f} (bound >= 0.9999); pixels on another surface "
        f"{disagree:.2e} (bound {RAYCAST_DISAGREE:.0e}); hit share "
        f"{float(hb.mean()):.4f}")
    check(hit_eq >= 0.9999, f"hit masks {hit_eq}")
    check(disagree <= RAYCAST_DISAGREE, f"raycast disagreement {disagree}")

    # frame vs render_rays on the same subset (where the raycasts agree)
    o_sub = origins.reshape(-1, 3)[idx]
    ref = np.asarray(jax.jit(
        lambda ds_, v_, m_, o, d: R.render_rays(cfg, ds_, v_, m_, o, d, cam,
                                                chunk_size=1024))(
        ds, voxels, mats, o_sub, d_sub))
    e = rel_rms(img.reshape(-1, 3)[idx][agree], ref[agree])
    say(f"frame vs render_rays on {int(agree.sum())} pixels: rel RMS "
        f"{e:.3e} (bound {FRAME_REL_RMS:.0e})")
    check(e <= FRAME_REL_RMS, f"frame rel RMS {e}")

    # alpha masks: the banners' masked texels re-cast past the hit
    g = jax.jit(lambda ds_, d, t, tri: GB.hits_to_gbuffer(
        ds_, GB.pinhole_constants(ds_, origin), origin, d, t, tri))(
        ds, d_sub, jnp.asarray(t_k), jnp.asarray(tri_k))
    alpha = np.asarray(mats.sample_albedo(g.material, g.uv)[..., 3])
    masked = int(np.sum(np.asarray(g.hit)
                        & (alpha < cfg.render.alpha_threshold)))
    say(f"alpha-masked primary hits in the subset: {masked} "
        f"(re-cast up to {cfg.render.alpha_mask_depth} times)")
    check(masked > 0, "the benchmark camera sees no masked texel")


def _one_frame(cfg, scene, camera):
    ds, mats, samples = R.prepare_scene(cfg, scene)
    voxels = R.build_voxel_state_staged(cfg, samples, mats)
    origins, dirs = cameralib.primary_rays(
        camera, cfg.render.width, cfg.render.height)
    cam = jnp.asarray(camera.position, jnp.float32)
    return np.asarray(R.render_camera_pass(cfg, ds, voxels, mats, origins,
                                           dirs, cam))


def phase_presets():
    cornell_cam = cameralib.Camera(position=(3.0, 2.0, 140.0))
    cases = [("cornell64", cornell_box(size=100.0), cornell_cam),
             ("cornell64_full", cornell_box(size=100.0), cornell_cam),
             ("aniso128", atrium(), BENCH_CAMERA),
             ("sponza256_exact_specular", atrium(), BENCH_CAMERA),
             ("inverse", cornell_box(size=100.0), cornell_cam),
             ("reference", atrium(), BENCH_CAMERA)]
    for name, scene, camera in cases:
        cfg = preset(name)
        img, dt = timed(lambda: _one_frame(cfg, scene, camera))
        bg = np.asarray(cfg.render.background, np.float32)
        lit = float(np.mean(np.any(np.abs(img - bg) > 1e-3, axis=-1)))
        say(f"preset {name}: {img.shape[1]}x{img.shape[0]} in {dt:.3f} s "
            f"(with compile); finite {bool(np.isfinite(img).all())}, "
            f"non-background share {lit:.4f}")
        check(np.isfinite(img).all() and lit > 0.05, f"preset {name}")


def phase_inverse():
    from vct_tpu.diff import inverse as I
    cfg = preset("inverse")
    camera = cameralib.Camera(position=(3.0, 2.0, 140.0))
    ds, mats, samples = R.prepare_scene(cfg, cornell_box(size=100.0))
    origins, dirs = cameralib.primary_rays(
        camera, cfg.render.width, cfg.render.height)
    cam = jnp.asarray(camera.position, jnp.float32)
    voxels = R.build_voxel_state(cfg, samples, mats)
    target = R.render_rays(cfg, ds, voxels, mats, origins, dirs, cam)
    start = {"albedo": jnp.clip(mats.albedo * 0.6 + 0.2, 0.0, 1.0)}
    grads = {}
    for camera_pass in ("fast", "xla"):
        inv = I.InverseConfig(optimize=("albedo",), camera_pass=camera_pass,
                              learning_rate=1e-2)
        loss_fn = I.make_loss_fn(inv, cfg, ds, cam)
        grads[camera_pass] = np.asarray(jax.grad(loss_fn)(
            start, samples, mats, origins, dirs, target)["albedo"])
        step, opt = I.make_step_fn(inv, cfg, ds, cam)
        params, state, losses = start, opt.init(start), []
        for _ in range(5):
            params, state, loss = step(params, state, samples, mats,
                                       origins, dirs, target)
            losses.append(float(loss))
        say(f"inverse camera_pass={camera_pass}: losses "
            + " ".join(f"{x:.6e}" for x in losses))
        check(np.all(np.isfinite(losses))
              and np.all(np.diff(losses) < 0),
              f"inverse {camera_pass} losses {losses}")
    gf, gx = grads["fast"], grads["xla"]
    e = float(np.linalg.norm(gf - gx) / max(np.linalg.norm(gx), 1e-30))
    say(f"albedo gradient, camera pass vs render_rays: relative "
        f"difference {e:.3e} (bound {GRAD_REL:.0e})")
    check(e <= GRAD_REL, f"gradient difference {e}")


def phase_four_cards():
    from vct_tpu.parallel import mesh as meshlib
    from vct_tpu.parallel import tile_dp
    base = preset("multihost512")
    cones = dataclasses.replace(base.cones, diffuse_mode="field",
                                specular_mode="field", field_basis=6)
    sharded = dataclasses.replace(
        base, cones=cones,
        sharding=dataclasses.replace(base.sharding, data_parallel=2,
                                     brick_parallel=2))
    single = dataclasses.replace(
        base, cones=cones,
        sharding=dataclasses.replace(base.sharding, data_parallel=1,
                                     brick_parallel=1))
    mesh = meshlib.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    ds, mats, samples = R.prepare_scene(single, atrium())
    # both builds at highest matmul precision: f32 contractions in TF32
    # would differ with the slab shapes the sharding gives them
    with jax.default_matmul_precision("highest"):
        v4, cold4 = timed(lambda: R.build_voxel_state_staged(
            sharded, samples, mats, mesh=mesh))
        _, warm4 = timed(lambda: R.build_voxel_state_staged(
            sharded, samples, mats, mesh=mesh))
        v1, cold1 = timed(lambda: R.build_voxel_state_staged(
            single, samples, mats))
        _, warm1 = timed(lambda: R.build_voxel_state_staged(
            single, samples, mats))
    say(f"512^3 build: brick-sharded on (data 2, model 2) cold {cold4:.3f} s"
        f" warm {warm4 * 1e3:.3f} ms; one card cold {cold1:.3f} s warm "
        f"{warm1 * 1e3:.3f} ms")
    say(f"  sharded diffuse field layout: {v4.diffuse_field.sharding}")
    bad = []
    for name in ("light_volume", "diffuse_field", "specular_field"):
        e = rel_rms(getattr(v4, name), getattr(v1, name))
        say(f"  {name}: brick-sharded vs one card rel RMS {e:.3e} "
            f"(bound 1e-5: the same f32 marches, halo-exchanged)")
        if not e <= 1e-5:
            bad.append(f"sharded build {name} {e}")
    del v4

    ds_hi, _, _ = R.prepare_scene(single, subdivide_scene(atrium(), 4),
                                  samples=samples)
    w, h = single.render.width, single.render.height
    origins, dirs = cameralib.primary_rays(BENCH_CAMERA, w, h)
    cam = jnp.asarray(BENCH_CAMERA.position, jnp.float32)
    mesh4 = meshlib.make_mesh(n_data=4, n_model=1, devices=jax.devices()[:4])
    fn4 = tile_dp.shardmap_camera_fn(single, ds_hi, mesh4,
                                     chunk_size=16384)
    img4, cold4 = timed(lambda: fn4(origins, dirs, cam, v1, mats))
    _, warm4 = timed(lambda: fn4(origins, dirs, cam, v1, mats))

    def frame1():
        return R.render_camera_pass(single, ds_hi, v1, mats, origins, dirs,
                                    cam)

    img1, cold1 = timed(frame1)
    _, warm1 = timed(frame1)
    e = float(np.max(np.abs(np.asarray(img4) - np.asarray(img1))))
    say(f"1080p frame: tile-DP over data=4 cold {cold4:.3f} s warm "
        f"{warm4 * 1e3:.3f} ms; one card cold {cold1:.3f} s warm "
        f"{warm1 * 1e3:.3f} ms; max abs difference {e:.3e} (bound 1e-5)")
    if not e <= 1e-5:
        bad.append(f"tile-DP frame difference {e}")
    check(not bad, "; ".join(bad))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args()
    enable_compile_cache()
    count = 4 if args.four_cards else 1
    phase_devices(count)         # exits before any other phase off a GPU

    if args.four_cards:
        phases = [("four cards", phase_four_cards)]
    else:
        ctx = {}
        phases = [("gpu tests", phase_gpu_tests),
                  ("build", lambda: phase_build(ctx)),
                  ("frame", lambda: phase_frame(ctx)),
                  ("presets", phase_presets),
                  ("inverse", phase_inverse)]
    failed = []
    for name, fn in phases:
        say(f"=== phase: {name}")
        t0 = time.perf_counter()
        try:
            fn()
            say(f"=== {name}: ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            traceback.print_exc(file=sys.stdout)
            say(f"=== {name}: FAILED")
            failed.append(name)
    say(f"card: {bench.card_line()}")
    if failed:
        say(f"failed phases: {failed}")
        sys.exit(1)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()

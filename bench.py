"""Benchmark: cone-samples/s/chip (the BASELINE.json headline metric).

Measures the cone-march kernel — the direction-major dense march
(core/dense.py) that computes the light-transmittance volume and the
basis cone-gather fields — at the target operating point (256^3 grid,
BASELINE.json config 3), plus the per-frame camera pass at 1080p and its
primary-visibility stage (the binned Triton raycast).

"cone-sample" = one quadrilinear voxel-pyramid fetch of the march: the
dense pass evaluates the exact per-point march at every field voxel for
every step (SURVEY.md §2.3 semantics), so samples = sum over marches of
steps x field_voxels.

vs_baseline: the reference publishes no numbers (BASELINE.json
"published": {}), so vs_baseline reports the achieved fraction of the
no-reuse HBM roofline for gathered marching (16 taps x 16 B per sample
at the card's published HBM bandwidth, PEAKS below) — dense marching can
exceed this roofline through on-chip reuse.

Runs on a GPU only (an unknown device_kind is an error, not a default).
Every timing is host clock around work that ends in
jax.block_until_ready.  Prints the card's name and power limit and other
diagnostics on stderr, and ONE JSON line on stdout.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# Published dense peaks per card, keyed by jax device_kind (NVIDIA H100
# SXM data sheet; rates without sparsity, at the 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops_per_s": 989e12,
        "tf32_flops_per_s": 495e12,
        "f32_flops_per_s": 67e12,
    },
}
BYTES_PER_SAMPLE = 16 * 4 * 4   # quadrilinear: 16 taps x RGBA x f32
CAMERA = dict(position=(48.0, -10.0, 0.0), yaw=180.0, pitch=10.0)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def peaks(device_kind: str) -> dict:
    """The published peaks of a card; unknown cards raise."""
    if device_kind not in PEAKS:
        raise ValueError(f"no published peaks for device_kind "
                         f"{device_kind!r}; add it to bench.PEAKS")
    return PEAKS[device_kind]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line)


def timed(fn, reps: int):
    """(first-call seconds incl. compile, warm seconds per call: median)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)), ts


def cost_analysis(compiled):
    """XLA's own (flops, bytes accessed) estimate for a compiled fn."""
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def count_dense_samples(cfg) -> int:
    """Cone samples evaluated by one build_voxel_state's dense marches."""
    from vct_tpu.render import shading

    dim = cfg.grid.dim
    df = shading.field_dim(cfg)
    b = cfg.cones.field_basis
    total = 0
    if cfg.shadow.mode == "volume":
        total += shading.shadow_schedule(cfg).num_steps * dim ** 3
    if cfg.cones.diffuse_mode == "field":
        total += b * shading.diffuse_schedule(cfg).num_steps * df ** 3
    if cfg.cones.trace_specular and cfg.cones.specular_mode == "field":
        # the field build marches the coarser field schedule
        total += b * shading.specular_field_schedule(cfg).num_steps * df ** 3
    return total


def main():
    scale = float(os.environ.get("VCT_BENCH_SCALE", "1.0"))
    width = int(1920 * scale)
    height = int(1080 * scale)
    dim = int(os.environ.get("VCT_BENCH_DIM", "256"))
    n_rep = int(os.environ.get("VCT_BENCH_REPS", "5"))

    from vct_tpu.config import preset
    from vct_tpu.core import camera as cameralib
    from vct_tpu.render import fast as F
    from vct_tpu.render import gbuffer as GB
    from vct_tpu.render import renderer as R
    from vct_tpu.render import shading
    from vct_tpu.scene import atrium
    from vct_tpu.scene.mesh import subdivide_scene
    from vct_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    kind = dev.device_kind
    log(f"device: {kind} ({dev.platform}) x{len(jax.devices())}")
    if dev.platform != "gpu":
        raise RuntimeError(f"bench.py measures a GPU; JAX runs on "
                           f"{dev.platform}")
    peak = peaks(kind)
    log(f"nvidia-smi: {card_line()}")

    cfg = preset("sponza256")
    cfg = dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, dim=dim),
        render=dataclasses.replace(cfg.render, width=width, height=height),
    )
    # Sponza-class colonnaded atrium (scene/atrium.py) at the SURVEY §6
    # operating point: textured materials, open light well, deep occlusion
    scene = atrium()
    camera = cameralib.Camera(**CAMERA)

    t0 = time.perf_counter()
    ds, mats, samples = R.prepare_scene(cfg, scene)
    log(f"scene prep: {samples.positions.shape[0]} surface samples, "
        f"{time.perf_counter() - t0:.3f} s")

    # --- the cone-march kernel: dense voxel build (volume + fields) ---
    build_first, build_dt, build_ts = timed(
        lambda: R.build_voxel_state_staged(cfg, samples, mats), n_rep)
    voxels = R.build_voxel_state_staged(cfg, samples, mats)
    dense_samples = count_dense_samples(cfg)
    sps = dense_samples / build_dt
    log(f"voxel build: first call {build_first:.3f} s (with compile); "
        f"warm median {build_dt * 1e3:.3f} ms over {n_rep} "
        f"(min {min(build_ts) * 1e3:.3f}, max {max(build_ts) * 1e3:.3f}); "
        f"dense march samples {dense_samples} -> {sps:.6e} samples/s")

    # the dominant dense-march stage (the diffuse cone-gather field build)
    # against XLA's own cost model: achieved HBM bytes/s and bf16 share
    march_fn = jax.jit(
        lambda mips: shading.build_cone_field(
            cfg, mips, shading.diffuse_schedule(cfg)))
    m_flops, m_bytes = cost_analysis(
        march_fn.lower(voxels.radiance_mips).compile())
    _, march_dt, _ = timed(lambda: march_fn(voxels.radiance_mips), n_rep)
    bw = peak["hbm_bytes_per_s"]
    march_gbps = m_bytes / march_dt / 1e9
    march_mxu = m_flops / march_dt / peak["bf16_flops_per_s"]
    log(f"dense march (diffuse field): {march_dt * 1e3:.3f} ms, XLA cost "
        f"model {m_flops:.6e} flop / {m_bytes:.6e} B -> {march_gbps:.3f} "
        f"GB/s ({march_gbps * 1e9 / bw:.4f} of peak HBM), "
        f"{march_mxu:.4f} of peak bf16")

    # --- per-frame camera pass at Sponza-class triangle counts ---
    # the frame renders the scene 4-way-subdivided (identical surfaces,
    # Voxel_Cone_Tracing.h:77 loads the 262k-tri Sponza); the voxel state
    # is geometry-identical
    subdiv = int(os.environ.get("VCT_BENCH_SUBDIV", "4"))
    scene_hi = subdivide_scene(scene, subdiv) if subdiv else scene
    ds_hi, _, _ = R.prepare_scene(cfg, scene_hi, samples=samples)
    frame_tris = int(ds_hi.v0.shape[0])
    origins, dirs = cameralib.primary_rays(camera, width, height)
    cam_pos = jnp.asarray(camera.position, jnp.float32)
    log(f"frame geometry: {frame_tris} triangles (subdiv {subdiv})")

    # primary-visibility stage alone: binning + Triton kernel
    _, raycast_dt, _ = timed(
        lambda: F.raycast_image(ds_hi, origins, dirs), n_rep)
    log(f"raycast stage (bin + kernel) at {frame_tris} tris: "
        f"{raycast_dt * 1e3:.3f} ms")

    # shading alone (G-buffer interpolation, material/atlas fetch, shadow
    # and field taps, combine) for the frame's closest hits
    t_img, tri_img = F.raycast_image(ds_hi, origins, dirs)
    light_dir = R.light_direction(cfg)

    @jax.jit
    def shade(ds_, voxels_, mats_, origins_, dirs_, t_, tri_):
        o = origins_.reshape(-1, 3)[0]
        return F.shade_hits(cfg, ds_, GB.pinhole_constants(ds_, o), voxels_,
                            mats_, o, dirs_.reshape(-1, 3), t_.reshape(-1),
                            tri_.reshape(-1), cam_pos, light_dir)

    _, shade_dt, _ = timed(lambda: shade(ds_hi, voxels, mats, origins, dirs,
                                         t_img, tri_img), n_rep)
    log(f"shading stage at {width}x{height}: {shade_dt * 1e3:.3f} ms")

    def frame():
        return R.render_camera_pass(cfg, ds_hi, voxels, mats, origins, dirs,
                                    cam_pos)

    frame_first, frame_dt, frame_ts = timed(frame, max(n_rep, 5))
    img = frame()
    log(f"first frame {frame_first:.3f} s (with compile), mean "
        f"{float(jnp.mean(img)):.6f}")
    log(f"steady frame: median {frame_dt * 1e3:.3f} ms over "
        f"{len(frame_ts)} ({width}x{height}, {1.0 / frame_dt:.3f} fps; "
        f"min {min(frame_ts) * 1e3:.3f}, max {max(frame_ts) * 1e3:.3f})")

    sol = bw / BYTES_PER_SAMPLE
    log(f"HBM no-reuse SoL: {sol:.6e} samples/s; fraction: {sps / sol:.4f}")

    print(json.dumps({
        "metric": "cone_samples_per_s_per_chip",
        "value": sps,
        "unit": "samples/s",
        "vs_baseline": sps / sol,
        "frame_ms_1080p": frame_dt * 1e3,
        "fps_1080p": 1.0 / frame_dt,
        "fast_path": True,
        "frame_tris": frame_tris,
        "raycast_ms": raycast_dt * 1e3,
        "shade_ms": shade_dt * 1e3,
        "march_achieved_gbps": march_gbps,
        "peak_gbps": bw / 1e9,
        "march_mxu_util": march_mxu,
        "build_ms": build_dt * 1e3,
        "device_kind": kind,
    }))


if __name__ == "__main__":
    main()

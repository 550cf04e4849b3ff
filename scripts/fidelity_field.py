"""Field-mode fidelity at the OPERATING POINT: 256^3 grid, field_dim 128
(the sponza256 default) and 256 (full grid), vs the exact per-pixel cone
march (the fs:82-107 oracle) on a sampled G-buffer pixel subset — plus a
mirror-material specular comparison and END-TO-END IMAGE errors (the
camera pass vs the percone-oracle renderer at the same pixels — the
number that matters: occlusion and albedo modulate the raw field error).

The full-grid diffuse field at 256^3 x 26 basis x vec4 would be 7 GB, so
the field-256 evaluation accumulates the per-pixel weighted taps
basis-group by basis-group (the tap is linear over basis fields) without
ever materializing the full field.

Writes relative RMS errors as JSON to VCT_FIDELITY_OUT (default
fidelity.json): if err(field128) ~= err(field256), the default
field_dim=128 (shading.field_dim) is justified — the error then comes
from the basis interpolation, not the field resolution.

Run on a GPU:  python scripts/fidelity_field.py
(tests/test_fidelity.py calls main() in-process with a smaller subset.)
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vct_tpu.config import preset  # noqa: E402
from vct_tpu.core import camera as cameralib  # noqa: E402
from vct_tpu.core import dense as D  # noqa: E402
from vct_tpu.render import renderer as R  # noqa: E402
from vct_tpu.render import shading  # noqa: E402
from vct_tpu.scene.atrium import atrium  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def rel_rms(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((x - ref) ** 2))
                 / max(np.sqrt(np.mean(ref ** 2)), 1e-9))


def field_taps_grouped(cfg, mips, sched, pos, nrm, weights, field_dim,
                      group=None):
    """sum_b w[:, b] * trilinear(G_b, p) accumulated per basis group —
    never materializes the full (df^3, B*4) field."""
    if group is None:
        group = 13 if field_dim <= 128 else 4    # 256^3 marches OOM above
    basis = D.direction_basis(cfg.cones.field_basis)
    out = jnp.zeros((pos.shape[0], 4), jnp.float32)
    p = pos + nrm * cfg.grid.voxel_world_size
    from vct_tpu.core import grid as G
    uvw = G.world_to_uvw(p, cfg.grid.world_size)

    for b0 in range(0, basis.shape[0], group):
        sub = basis[b0:b0 + group]                # static: the march's
                                                  # shifts are compile-time

        @jax.jit
        def one_group(mips_, uvw_, sub=sub):
            f = D.directional_march_multi(
                mips_, sub, sched, cfg.grid.world_size,
                field_dim=field_dim, max_alpha=cfg.cones.max_alpha,
                occlusion_falloff=cfg.cones.occlusion_falloff,
                compute_dtype=jnp.bfloat16)       # (g, df, df, df, 4)
            return jax.vmap(lambda vol: G.trilinear_sample(vol, uvw_))(f)

        taps = one_group(mips, uvw)
        w = weights[:, b0:b0 + sub.shape[0]]      # (n, g)
        out = out + jnp.einsum("gnc,ng->nc", taps, w)
    return out


def main(out_path=None, stage=None, dfs=None, nsub=None):
    """Measure; returns the result dict (also written to out_path).
    Defaults come from VCT_FIDELITY_{OUT,STAGE,DF,N}."""
    from vct_tpu.render import fast as F
    from vct_tpu.render.gbuffer import hits_to_gbuffer, pinhole_constants

    cfg = preset("sponza256")
    scene = atrium()
    camera = cameralib.Camera(position=(48.0, -10.0, 0.0), yaw=180.0)
    ds, mats, samples = R.prepare_scene(cfg, scene)
    t0 = time.time()
    voxels = R.build_voxel_state_staged(cfg, samples, mats)
    jax.block_until_ready(voxels.radiance_mips[0])
    log(f"voxel build: {time.time()-t0:.1f}s")

    # G-buffer pixel subset
    w, h = 480, 272
    origins, dirs = cameralib.primary_rays(camera, w, h)
    origin = origins.reshape(-1, 3)[0]
    t, tri = F.raycast_image(ds, origins, dirs)
    g = hits_to_gbuffer(ds, pinhole_constants(ds, origin), origin,
                        dirs.reshape(-1, 3), t.reshape(-1), tri.reshape(-1))
    hits = np.nonzero(np.asarray(g.hit))[0]
    rng = np.random.RandomState(0)
    if nsub is None:
        nsub = int(os.environ.get("VCT_FIDELITY_N", "2048"))
    sel = rng.choice(hits, size=min(nsub, len(hits)), replace=False)
    pos = jnp.asarray(np.asarray(g.position)[sel])
    nrm = jnp.asarray(np.asarray(g.normal)[sel])
    tan = jnp.asarray(np.asarray(g.tangent)[sel])
    bit = jnp.asarray(np.asarray(g.bitangent)[sel])
    n = pos.shape[0]
    log(f"pixel subset: {n} of {len(hits)} hits")

    mips = voxels.radiance_mips
    basis = D.direction_basis(cfg.cones.field_basis)
    cone_dirs = shading.pixel_cone_dirs(cfg, nrm, tan, bit)   # (n, K, 3)
    sched_d = shading.diffuse_schedule(cfg)
    sched_s = shading.specular_schedule(cfg)

    # ---- percone oracle (exact fs semantics) ----
    t0 = time.time()
    oracle_rgb, oracle_occ = shading.indirect_diffuse_percone(
        cfg, mips, pos, nrm, cone_dirs)
    oracle = jnp.concatenate(
        [oracle_rgb, oracle_occ[:, None]], axis=1)
    jax.block_until_ready(oracle)
    log(f"percone diffuse oracle: {time.time()-t0:.1f}s")

    # diffuse basis weights folded over cones (the field-mode weighting)
    wb = D.basis_weights(cone_dirs, basis, cfg.cones.basis_power_diffuse)
    from vct_tpu.core import cones as C
    cw = jnp.asarray(C.CONE_WEIGHTS[: cfg.cones.num_diffuse_cones])
    w_diff = jnp.einsum("k,nkb->nb", cw, wb)

    if stage is None:
        stage = os.environ.get("VCT_FIDELITY_STAGE", "all")
    res = {}
    if dfs is None:
        dfs = tuple(int(x) for x in os.environ.get(
            "VCT_FIDELITY_DF", "128,256").split(","))
    if stage in ("all", "diffuse"):
        for df in dfs:
            t0 = time.time()
            out = field_taps_grouped(cfg, mips, sched_d, pos, nrm, w_diff,
                                     df)
            jax.block_until_ready(out)
            err = rel_rms(out, oracle)
            res[f"diffuse_field{df}_rel_rms"] = err
            log(f"field {df}^3 diffuse: rel RMS {err:.4f} "
                f"({time.time()-t0:.1f}s)")

    # ---- end-to-end image error: camera pass vs percone-oracle pixels ----
    if stage in ("all", "image"):
        import dataclasses as _dc
        d_sel = jnp.asarray(dirs.reshape(-1, 3)[sel])
        o_sel = jnp.asarray(origins.reshape(-1, 3)[sel])
        cam_pos = jnp.asarray(camera.position, jnp.float32)
        cfg_o = _dc.replace(cfg, cones=_dc.replace(
            cfg.cones, diffuse_mode="percone", specular_mode="percone"))
        img_oracle = np.asarray(R.render_rays(
            cfg_o, ds, voxels, mats, o_sel, d_sel, cam_pos,
            chunk_size=2048))
        for name, cfg_f in (
                ("image_field_rel_rms", cfg),
                ("image_exact_specular_rel_rms",
                 preset("sponza256_exact_specular"))):
            img = np.asarray(R.render_camera_pass(
                cfg_f, ds, voxels, mats, origins, dirs, cam_pos))
            err = rel_rms(img.reshape(-1, 3)[sel], img_oracle)
            res[name] = err
            log(f"{name}: rel RMS {err:.4f}")

    # ---- mirror-material specular: refl-dir cone vs basis field ----
    if stage in ("all", "specular"):
        eye = pos - jnp.asarray(camera.position, jnp.float32)
        eye = -eye / jnp.linalg.norm(eye, axis=1, keepdims=True)
        refl = shading.reflect_eye(nrm, eye)
        t0 = time.time()
        s_rgb, s_occ = shading.indirect_specular_percone(cfg, mips, pos,
                                                         nrm, refl)
        spec_oracle = jnp.concatenate([s_rgb, s_occ[:, None]], axis=1)
        jax.block_until_ready(spec_oracle)
        log(f"percone specular oracle: {time.time()-t0:.1f}s")
        w_spec = D.basis_weights(refl, basis,
                                 cfg.cones.basis_power_specular)
        for df in dfs:
            out = field_taps_grouped(cfg, mips, sched_s, pos, nrm, w_spec,
                                     df)
            jax.block_until_ready(out)
            err = rel_rms(out, spec_oracle)
            res[f"specular_field{df}_rel_rms"] = err
            log(f"field {df}^3 specular (mirror dirs): rel RMS {err:.4f}")

    res["n_pixels"] = int(n)
    res["grid_dim"] = cfg.grid.dim
    res["basis"] = int(cfg.cones.field_basis)
    res["power_diffuse"] = float(cfg.cones.basis_power_diffuse)
    res["power_specular"] = float(cfg.cones.basis_power_specular)
    if out_path is None:
        out_path = os.environ.get("VCT_FIDELITY_OUT", "fidelity.json")
    try:
        with open(out_path) as f:
            prev = json.load(f)
    except Exception:
        prev = {}
    prev.update(res)
    with open(out_path, "w") as f:
        json.dump(prev, f, indent=1)
    print(json.dumps(prev))
    return prev


if __name__ == "__main__":
    main()

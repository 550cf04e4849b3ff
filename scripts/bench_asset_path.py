"""End-to-end ASSET-PATH bench at reference scale.

The reference loads a real 262k-triangle Sponza OBJ with dozens of
textures through Assimp + stb_image (Voxel_Cone_Tracing.h:77,
Model.h:43,141-186).  This script exercises the repo's equivalent C5/C6
path at that scale end to end:

  1. GENERATE (deterministic, cached): the atrium subdivided to ~287k
     triangles, its materials expanded to 20 texture-carrying variants
     (checker/brick/fabric procedural textures, 256^2), written as
     OBJ + MTL + 14 PNG + 6 baseline-JPEG files.  JPEGs are encoded
     with Pillow — generation-side tooling only; DECODE runs through
     the repo's own readers (utils/image.py), which is the path under
     test.
  2. LOAD through scene/obj.py (native C++ parser + Python MTL/texture
     decode), timed per phase.
  3. prepare_scene -> 256^3 voxel build -> 1080p camera pass
     (renderer.render_camera_pass) on the default backend, timed; every
     timing ends in jax.block_until_ready.

The generated scene goes to VCT_ASSET_DIR (default <checkout>/.asset_scene,
listed in .gitignore).  Writes VCT_ASSET_OUT (default asset.json) and
prints one JSON line.
Run: python scripts/bench_asset_path.py
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _textures(rng, kind, color):
    """Deterministic 256^2 rgb texture in [0,1]."""
    r = 256
    yy, xx = np.mgrid[0:r, 0:r] / r
    base = np.asarray(color, np.float32)
    if kind == "checker":
        c = (((yy * 8).astype(int) + (xx * 8).astype(int)) % 2)
        img = base * (0.6 + 0.4 * c[..., None])
    elif kind == "brick":
        row = (yy * 16).astype(int)
        mort = ((xx * 8 + 0.5 * (row % 2)) % 1.0 < 0.06) | (yy * 16 % 1.0 < 0.12)
        img = np.where(mort[..., None], base * 0.45, base)
    else:  # noise fabric
        n = rng.uniform(0.75, 1.0, (32, 32, 1)).repeat(8, 0).repeat(8, 1)
        img = base * n
    img = img + rng.uniform(-0.02, 0.02, (r, r, 3))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def generate(root: str, subdiv: int) -> str:
    from vct_tpu.scene.atrium import atrium
    from vct_tpu.scene.mesh import subdivide_scene
    from vct_tpu.utils.image import write_png

    obj_path = os.path.join(root, "atrium_hi.obj")
    if os.path.exists(obj_path):
        return obj_path
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(7)
    scene = subdivide_scene(atrium(), subdiv)
    t = scene.indices.shape[0]
    log(f"generate: {t} tris")

    # 20 material variants: 4 texture-kinds x 5 hues; deterministic
    # reassignment of the atrium's triangles by their base material
    kinds = ["checker", "brick", "fabric", "checker"]
    hues = [(0.8, 0.75, 0.7), (0.7, 0.45, 0.35), (0.35, 0.5, 0.7),
            (0.45, 0.65, 0.4), (0.75, 0.7, 0.5)]
    names, texfiles = [], []
    from PIL import Image
    for i in range(20):
        kind = kinds[i % 4]
        img = _textures(rng, kind, hues[i // 4])
        ext = "jpg" if i % 10 < 3 else "png"   # 6 jpg + 14 png
        fn = f"tex_{i:02d}.{ext}"
        fp = os.path.join(root, fn)
        if ext == "png":
            write_png(fp, img)
        else:
            Image.fromarray(
                (img * 255).astype(np.uint8)).save(fp, quality=92)
        names.append(f"mat{i:02d}")
        texfiles.append(fn)

    # MTL: every material textured; a few carry specular maps
    with open(os.path.join(root, "atrium_hi.mtl"), "w") as f:
        for i, name in enumerate(names):
            f.write(f"newmtl {name}\n")
            f.write("Kd 1.0 1.0 1.0\nKs 0.2 0.2 0.2\n")
            f.write(f"Ns {10 + 5 * (i % 5)}\n")
            f.write(f"map_Kd {texfiles[i]}\n")
            if i % 5 == 0:
                f.write(f"map_Ks {texfiles[(i + 1) % 20]}\n")
            f.write("\n")

    # triangle materials: base material -> variant by spatial hash
    centro = scene.positions[scene.indices].mean(axis=1)
    h = (np.floor(centro[:, 0] / 15) + 3 * np.floor(centro[:, 2] / 15)
         ).astype(np.int64)
    tri_mat = (scene.tri_material.astype(np.int64) * 5
               + np.abs(h) % 5) % 20

    with open(obj_path, "w") as f:
        f.write("mtllib atrium_hi.mtl\n")
        np.savetxt(f, scene.positions, fmt="v %.6f %.6f %.6f")
        np.savetxt(f, scene.uvs, fmt="vt %.6f %.6f")
        np.savetxt(f, scene.normals, fmt="vn %.5f %.5f %.5f")
        order = np.argsort(tri_mat, kind="stable")
        faces = scene.indices[order] + 1
        fmat = tri_mat[order]
        bounds = np.flatnonzero(np.diff(fmat)) + 1
        for blk, m0 in zip(np.split(faces, bounds),
                           fmat[np.concatenate([[0], bounds])]):
            f.write(f"usemtl {names[m0]}\n")
            # v/vt/vn share one index per vertex (parallel arrays)
            np.savetxt(f, np.repeat(blk, 3, axis=1),
                       fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
    return obj_path


def main():
    root = os.environ.get("VCT_ASSET_DIR",
                          os.path.join(REPO, ".asset_scene"))
    subdiv = int(os.environ.get("VCT_ASSET_SUBDIV", "4"))
    t0 = time.time()
    obj_path = generate(root, subdiv)
    gen_s = time.time() - t0

    import jax
    import jax.numpy as jnp
    from vct_tpu.config import preset
    from vct_tpu.core import camera as cameralib
    from vct_tpu.render import renderer as R
    from vct_tpu.scene.obj import load_obj
    from vct_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()

    t0 = time.time()
    scene = load_obj(obj_path)
    load_s = time.time() - t0
    tris = scene.indices.shape[0]
    ntex = sum(1 for m in scene.materials if m.albedo_texture is not None)
    log(f"load: {tris} tris, {len(scene.materials)} materials, "
        f"{ntex} textured, {load_s:.2f}s")

    cfg = preset("sponza256")
    camera = cameralib.Camera(position=(48.0, -10.0, 0.0), yaw=180.0)
    t0 = time.time()
    ds, mats, samples = R.prepare_scene(cfg, scene)
    prep_s = time.time() - t0
    t0 = time.time()
    voxels = jax.block_until_ready(
        R.build_voxel_state_staged(cfg, samples, mats))
    build_s = time.time() - t0

    origins, dirs = cameralib.primary_rays(camera, 1920, 1080)
    cam = jnp.asarray(camera.position, jnp.float32)

    def frame():
        return jax.block_until_ready(R.render_camera_pass(
            cfg, ds, voxels, mats, origins, dirs, cam))

    t0 = time.time()
    img = frame()
    compile_s = time.time() - t0
    reps = int(os.environ.get("VCT_ASSET_REPS", "5"))
    t0 = time.time()
    for _ in range(reps):
        img = frame()
    frame_ms = (time.time() - t0) / reps * 1e3
    mean = float(jnp.mean(img))
    log(f"frame: {frame_ms:.1f} ms (compile {compile_s:.1f}s, "
        f"mean {mean:.4f})")

    res = {
        "tris": int(tris),
        "materials": len(scene.materials),
        "textured_materials": int(ntex),
        "generate_s": gen_s,
        "obj_load_s": load_s,
        "prepare_scene_s": prep_s,
        "voxel_build_s": build_s,
        "frame_ms_1080p": frame_ms,
        "image_mean": mean,
    }
    out = os.environ.get("VCT_ASSET_OUT", "asset.json")
    with open(out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()

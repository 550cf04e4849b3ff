"""Primary-visibility timing at the bench operating point: the binned
Triton raycast (binning + kernel) vs the XLA brute force, at 1080p on the
4-way-subdivided atrium (287,232 triangles), plus a sweep of the kernel's
block shape.

Both timings are warm and end in jax.block_until_ready.  The brute force
is gbuffer.pinhole_hits, over ray chunks small enough that its
(chunk x triangles) f32 arrays fit the card.

Usage (on a GPU):  python scripts/bench_raycast.py [--sweep] [--reps N]
Prints one JSON line on stdout; diagnostics on stderr.
"""

import argparse
import json
import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from vct_tpu.core import camera as cameralib  # noqa: E402
from vct_tpu.ops import binrast_pallas as BR  # noqa: E402
from vct_tpu.render import fast as F  # noqa: E402
from vct_tpu.render import gbuffer as GB  # noqa: E402
from vct_tpu.scene import atrium  # noqa: E402
from vct_tpu.scene.mesh import subdivide_scene  # noqa: E402
from vct_tpu.utils.profiling import enable_compile_cache  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def timed(fn, reps):
    """(first-call seconds incl. compile, median warm seconds)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts))


def operating_point(width=1920, height=1080, subdiv=4):
    ds = GB.DeviceScene.from_scene(subdivide_scene(atrium(), subdiv))
    origins, dirs = cameralib.primary_rays(cameralib.Camera(**bench.CAMERA),
                                           width, height)
    return ds, origins, dirs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true",
                    help="time RAYS x SLICE x num_warps block shapes")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=1024,
                    help="brute-force rays per chunk")
    args = ap.parse_args()
    enable_compile_cache()
    dev = jax.devices()[0]
    log(f"device: {dev.device_kind} ({dev.platform}) x{len(jax.devices())}")
    ds, origins, dirs = operating_point()
    ntri = int(ds.v0.shape[0])
    log(f"{ntri} triangles, {dirs.shape[1]}x{dirs.shape[0]} rays")

    def binned():
        return F.raycast_image(ds, origins, dirs)

    res = {"device_kind": dev.device_kind, "triangles": ntri}
    first, warm = timed(binned, args.reps)
    res.update(binned_first_s=first, binned_ms=warm * 1e3,
               block=[BR.RAYS, BR.SLICE, BR.NUM_WARPS, BR.NUM_STAGES])
    log(f"binned (bin + kernel): {warm * 1e3:.3f} ms warm, "
        f"{first:.1f} s first call")

    if args.sweep:
        sweep = []
        for rays, sl, warps in ((32, 32, 2), (64, 32, 4), (128, 32, 4),
                                 (64, 64, 4), (128, 64, 8), (64, 16, 2),
                                 (128, 32, 8)):
            BR.RAYS, BR.SLICE, BR.NUM_WARPS = rays, sl, warps
            jax.clear_caches()
            try:
                _, w = timed(binned, args.reps)
                sweep.append([rays, sl, warps, w * 1e3])
                log(f"  RAYS={rays} SLICE={sl} warps={warps}: "
                    f"{w * 1e3:.3f} ms")
            except Exception as e:   # a shape the compiler refuses
                log(f"  RAYS={rays} SLICE={sl} warps={warps}: "
                    f"{type(e).__name__}: {str(e)[:200]}")
        res["sweep_ms"] = sweep

    bf = jax.jit(GB.pinhole_hits, static_argnames=("chunk_size",))
    first, warm = timed(
        lambda: bf(ds, origins.reshape(-1, 3)[0], dirs.reshape(-1, 3),
                   chunk_size=args.chunk), max(1, args.reps // 2))
    res.update(brute_first_s=first, brute_ms=warm * 1e3,
               brute_chunk=args.chunk)
    log(f"brute force (chunk {args.chunk}): {warm * 1e3:.3f} ms warm")
    print(json.dumps(res))


if __name__ == "__main__":
    main()

"""bfloat16 dense-march compute (GridConfig.compute="bfloat16").

The contractions run in bf16 with f32 accumulation; results
must track the f32 path within bf16's ~0.4% per-tap relative error.  Note
the reference stores voxels as RGBA8 (Voxel_Cone_Tracing.h:119) — 8-bit
fixed point — so bf16 still exceeds the reference's own precision.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from vct_tpu.config import preset, GridConfig
from vct_tpu.core import dense as D
from vct_tpu.core import grid as G
from vct_tpu.core import march as M


def make_mips(dim=32, seed=0):
    rng = np.random.default_rng(seed)
    base = np.zeros((dim, dim, dim, 4), np.float32)
    for _ in range(120):
        i, j, k = rng.integers(1, dim - 1, size=3)
        base[i, j, k] = [*rng.uniform(0.2, 1.0, 3), rng.uniform(0.3, 1.0)]
    return G.build_mips(jnp.asarray(base))


DIRS = np.asarray([[0.0, 0.0, 1.0], [0.6, -0.64, 0.48]])
DIRS = DIRS / np.linalg.norm(DIRS, axis=-1, keepdims=True)


class TestBf16March:
    def test_march_tracks_f32(self):
        ws, dim = 150.0, 32
        mips = make_mips(dim)
        sched = M.march_schedule(0.577, ws / dim, 75.0)
        ref = D.directional_march_multi(mips, DIRS, sched, ws)
        out = D.directional_march_multi(mips, DIRS, sched, ws,
                                        compute_dtype=jnp.bfloat16)
        assert out.dtype == jnp.float32
        ref = np.asarray(ref)
        out = np.asarray(out)
        # relative-to-range error bound
        scale = max(np.abs(ref).max(), 1e-3)
        assert np.abs(out - ref).max() / scale < 0.02

    def test_transmittance_tracks_f32(self):
        ws, dim = 150.0, 32
        mips = make_mips(dim, seed=1)
        sched = M.march_schedule(0.2, ws / dim, ws, step_factor=0.5)
        kw = dict(opacity_gain=4.0, transmittance_only=True)
        ref = np.asarray(D.directional_march_multi(
            mips, DIRS[:1], sched, ws, **kw))
        out = np.asarray(D.directional_march_multi(
            mips, DIRS[:1], sched, ws, compute_dtype=jnp.bfloat16, **kw))
        assert np.abs(out - ref).max() < 0.03

    def test_preset_and_field_build(self):
        from vct_tpu.render import shading
        cfg = preset("sponza256")
        assert cfg.grid.compute == "bfloat16"
        cfg = dataclasses.replace(
            cfg, grid=GridConfig(dim=32, world_size=150.0,
                                 compute="bfloat16"))
        mips = make_mips(32, seed=2)
        field = shading.build_cone_field(cfg, mips,
                                         shading.diffuse_schedule(cfg))
        f = np.asarray(field)
        assert f.dtype == np.float32 and np.isfinite(f).all()
        assert f.max() > 0

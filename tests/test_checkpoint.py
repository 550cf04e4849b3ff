"""diff/checkpoint.py: np.savez checkpoints of (params, optax state, step)."""

import jax.numpy as jnp
import numpy as np
import optax

from vct_tpu.diff import checkpoint as ckpt
from vct_tpu.diff.inverse import OptimState


def _state(step, scale=1.0):
    params = {"albedo": jnp.full((3, 4), 0.5 * scale),
              "light": jnp.ones(3) * scale}
    opt = optax.adam(1e-2)
    return OptimState(params=params, opt_state=opt.init(params), step=step)


def test_roundtrip_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    assert ckpt.restore_latest(d, _state(0)) is None
    ckpt.save(d, _state(3, 2.0))
    ckpt.save(d, _state(10, 3.0))
    assert ckpt.available_steps(d) == [3, 10]
    back = ckpt.restore_latest(d, _state(0))
    assert back.step == 10
    np.testing.assert_array_equal(np.asarray(back.params["albedo"]),
                                  np.full((3, 4), 1.5))
    assert back.opt_state[0].count.dtype == jnp.int32


def test_restore_specific_step(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, _state(1, 1.0))
    ckpt.save(d, _state(2, 4.0))
    back = ckpt.restore(d, 1, _state(0))
    assert back.step == 1
    np.testing.assert_array_equal(np.asarray(back.params["light"]),
                                  np.ones(3))

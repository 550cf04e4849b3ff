"""Checkpoint/resume for inverse-rendering optimization.

The reference has no persistent state at all (SURVEY.md §5 "Checkpoint:
none — everything rebuilt at startup"); here optimization state
(parameter pytree + optax state + step) saves/restores so long inverse
runs survive restarts.

Layout: <dir>/step_<N>.npz holds the flattened (params, opt_state) leaves
in tree order plus the step; restore_latest picks the highest step and
unflattens against a template of the same structure.  Arrays restore to
the default device; the sharded train path re-annotates via jit
in_shardings.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from vct_tpu.diff.inverse import OptimState

_STEP_RE = re.compile(r"^step_(\d+)\.npz$")


def _step_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}.npz")


def save(directory: str, state: OptimState) -> str:
    """Write one checkpoint; returns its path."""
    os.makedirs(directory, exist_ok=True)
    path = _step_path(directory, state.step)
    leaves = jax.tree_util.tree_leaves((state.params, state.opt_state))
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    tmp = path + ".tmp.npz"
    np.savez(tmp, step=np.asarray(state.step, np.int64), **arrays)
    os.replace(tmp, path)       # a crash mid-write leaves no torn file
    return path


def available_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def restore(directory: str, step: int, template: OptimState) -> OptimState:
    """Restore one checkpoint shaped like `template`."""
    treedef = jax.tree_util.tree_structure(
        (template.params, template.opt_state))
    with np.load(_step_path(directory, step)) as z:
        leaves = [jnp.asarray(z[f"leaf_{i}"])
                  for i in range(treedef.num_leaves)]
        saved_step = int(z["step"])
    params, opt_state = jax.tree_util.tree_unflatten(treedef, leaves)
    return OptimState(params=params, opt_state=opt_state, step=saved_step)


def restore_latest(directory: str,
                   template: OptimState) -> Optional[OptimState]:
    """Latest checkpoint in `directory`, or None if there is none."""
    steps = available_steps(directory)
    if not steps:
        return None
    return restore(directory, steps[-1], template)

"""Tracing / profiling subsystem (SURVEY.md §5).

The reference computes a frame delta and never shows it (main.cpp:83-87);
here every pipeline stage is timed explicitly (host clock around work
that ends in jax.block_until_ready), with optional Perfetto traces via
jax.profiler, and JAX's persistent compilation cache for the entry
points (cli.py, bench.py, chip_smoke.py).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import List, Optional, Tuple

import jax

# <checkout>/.jax_cache: a fixed path, since the cache key includes it
_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jax_cache."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_CACHE


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.
    Where JAX_COMPILATION_CACHE_DIR is set JAX already uses it, and no
    other directory is set here."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def sync(x):
    """Block until every array in x is computed; returns x."""
    return jax.block_until_ready(x)


class StageTimer:
    """Wall-clock stage timing with device synchronization.

    with timer.stage("voxelize"):
        out = ...
        timer.done(out)      # sync point; optional — stage end syncs too
    """

    def __init__(self, log=None):
        self.records: List[Tuple[str, float]] = []
        self._log = log

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.time()
        box = {}
        try:
            yield box
        finally:
            if "result" in box:
                sync(box["result"])
            dt = time.time() - t0
            self.records.append((name, dt))
            if self._log:
                self._log(f"[{name}] {dt * 1e3:.1f} ms")

    def report(self) -> str:
        total = sum(dt for _, dt in self.records)
        lines = [f"{name:<24s} {dt * 1e3:10.1f} ms  {dt / total * 100:5.1f}%"
                 for name, dt in self.records]
        lines.append(f"{'total':<24s} {total * 1e3:10.1f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def perfetto_trace(trace_dir: Optional[str]):
    """jax.profiler trace scope -> Perfetto-compatible artifacts in
    trace_dir (no-op when trace_dir is None)."""
    if not trace_dir:
        yield
        return
    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        print(f"profiler trace written to {trace_dir}", file=sys.stderr)

"""Persistent XLA compilation cache location.

Entry points (cli.main, bench.py, chip_smoke.py) call `enable()` before
their first compile.  If JAX_COMPILATION_CACHE_DIR is set, JAX already
uses it and nothing else is configured; otherwise accelerator runs cache
in `<repo>/.jax_cache` (a fixed path, so later runs of the same checkout
find it again).  CPU runs (tests, rehearsals) compile in seconds and
keep no default cache.
"""

from __future__ import annotations

import os

import jax

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_DIR, '.jax_cache')


def enable():
    """Point JAX's persistent compilation cache at its directory and
    return that directory (None on the CPU without the variable)."""
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    if jax.default_backend() == 'cpu':
        return None
    jax.config.update('jax_compilation_cache_dir', DEFAULT_DIR)
    return DEFAULT_DIR

"""Multi-host execution: process bootstrap + global meshes + host-local IO.

The reference scales inside one box with OpenMP threads (Raytracer.cpp
render loops); here the scaling story is SPMD over several hosts: every
host runs this same program, `jax.distributed.initialize` wires the JAX
runtime across them, and the `Mesh` spans the GLOBAL device set so
`shard_map` collectives (film psum) ride the device links within a host
and the network between hosts.

What lives here:
  * init_multihost()    — idempotent jax.distributed bootstrap (explicit
                          coordinator address, process count and id).
  * global_mesh()       — a ('dp','sp') Mesh over ALL processes' devices.
  * host_shard_rows()   — which image rows this process renders; pair
                          with `jax.make_array_from_process_local_data`
                          to assemble the global film without gathering
                          pixels on one host.
  * checkpoint paths    — per-process unique filenames so the render
                          checkpoints (render/renderer.py save/resume)
                          do not collide on shared filesystems.

Single-process use (tests, one chip) needs no initialize call: every
helper degrades to the local device set.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import jax
from jax.sharding import Mesh

_initialized = False


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> Tuple[int, int]:
    """Bootstrap the cross-host runtime; returns (process_id, n_processes).

    Pass the coordinator address, process count and this process's id
    explicitly; on clusters whose environment jax.distributed can read they
    may be None (reference-free: this replaces nothing in the C++ —
    the reference never scaled past one box).  Idempotent: safe to call
    again (including in single-process runs, where it is a no-op).
    """
    global _initialized
    if num_processes in (None, 1) and coordinator_address is None \
            and jax.process_count() == 1 and not _initialized:
        # single process: nothing to wire
        _initialized = True
        return jax.process_index(), jax.process_count()
    if not _initialized:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
        _initialized = True
    return jax.process_index(), jax.process_count()


def global_mesh(dp: Optional[int] = None, sp: int = 1) -> Mesh:
    """A ('dp','sp') mesh over the GLOBAL device set (all hosts).

    Defaults to dp = total_devices // sp.  The same mesh axes feed
    parallel/sharding.py's make_sharded_render / make_train_step — those
    shard_maps are process-agnostic, so the one program runs unchanged
    from 1 chip to a pod slice.
    """
    devs = np.asarray(jax.devices())          # global across processes
    n = devs.size
    if dp is None:
        dp = n // sp
    assert dp * sp == n, f"dp*sp={dp * sp} != devices={n}"
    return Mesh(devs.reshape(dp, sp), ('dp', 'sp'))


def host_shard_rows(height: int, mesh: Mesh) -> tuple:
    """The [row0, row1) slab of the image this PROCESS must provide.

    With the film row-sharded over 'dp', each process materializes only
    its local rows and assembles the global array with
    jax.make_array_from_process_local_data — pixels never funnel through
    one host.  Returns (row0, row1, rows_per_shard).
    """
    dp = mesh.shape['dp']
    assert height % dp == 0, f"height {height} not divisible by dp={dp}"
    rows = height // dp
    # which dp-shards live on this process?
    local = {d.process_index: [] for d in mesh.devices.flat}
    mine = [i for i in range(dp)
            if mesh.devices[i, 0].process_index == jax.process_index()]
    del local
    if not mine:
        return 0, 0, rows
    return min(mine) * rows, (max(mine) + 1) * rows, rows


def checkpoint_path(base: str) -> str:
    """Per-process checkpoint filename (multi-host safe on shared FS)."""
    pid = jax.process_index()
    if jax.process_count() == 1:
        return base
    root, ext = os.path.splitext(base)
    return f"{root}.p{pid}{ext}"


class PreemptionGuard:
    """Preemption-aware render loops (SURVEY §5 failure recovery).

    Preemptible machines get a SIGTERM from the scheduler and
    the job a grace window.  Used as a context manager, this arms a
    handler that only FLAGS the request — the render loop finishes its
    in-flight wave, checkpoints, and exits cleanly (the functional wave
    step makes 'finish the wave then save' exactly resumable; see
    Renderer.render_resumable).  Previous handlers are chained so outer
    supervisors still observe the signal, and the original disposition is
    restored on exit.

    `requested` may also be set programmatically (tests, cooperative
    shutdown from a coordinator thread).
    """

    def __init__(self, signals=None):
        import signal as _signal
        self._signal = _signal
        self.signals = tuple(signals) if signals is not None else (
            _signal.SIGTERM, _signal.SIGINT)
        self.requested = False
        self._prev = {}

    def _handler(self, signum, frame):
        self.requested = True
        prev = self._prev.get(signum)
        if callable(prev):
            prev(signum, frame)

    def __enter__(self):
        for s in self.signals:
            self._prev[s] = self._signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            self._signal.signal(s, prev)
        self._prev.clear()
        return False

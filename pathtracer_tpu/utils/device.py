"""The accelerator a measurement runs on.

Measurement entry points (bench.py, chip_smoke.py) call `require_gpu()`
first: a timing taken on another platform is not a device number, so
they stop instead of falling back to the CPU."""

from __future__ import annotations

import shutil
import subprocess

import jax


def require_gpu():
    """Return jax.devices() if they are GPUs, else exit with an error."""
    devs = jax.devices()
    if devs[0].platform != 'gpu':
        raise SystemExit(f'no GPU found (JAX platform {devs[0].platform!r})')
    return devs


def describe():
    """{'platform', 'kind', 'count'} as JAX reports the devices."""
    devs = jax.devices()
    return {'platform': devs[0].platform, 'kind': devs[0].device_kind,
            'count': len(devs)}


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output (one line per
    card), or a note when nvidia-smi is absent."""
    exe = shutil.which('nvidia-smi')
    if exe is None:
        return 'nvidia-smi: not found'
    out = subprocess.run(
        [exe, '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()

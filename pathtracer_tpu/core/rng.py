"""Counter-keyed PCG32 random streams, bit-exact with the reference's pcg32.

The reference path tracer draws uniforms from 64 thread-local ``pcg32`` engines
(reference: Vector.h:29, Raytracer.h:31-33).  Thread-local streams do not map to
a wavefront's SPMD execution model, so here every *path* (pixel, sample) owns its own
PCG32 stream, selected by the PCG "sequence" (stream) parameter.  The generator
itself is the exact PCG XSH-RR 64/32 engine from the vendored pcg_random.hpp
(reference: pcg_random.hpp:845-871 output fn, :484-499 seeding, :413-420 bump),
implemented on pairs of uint32 lanes so it needs no 64-bit integer support
(JAX's default x64-off mode has no uint64).

All state is a pair of uint32 arrays ``(hi, lo)`` representing the 64-bit PCG
state.  Streams:

    engine = pcg32(initstate=key, initseq=key)

which in pcg_random.hpp semantics means::

    inc   = (key << 1) | 1
    state = ((key + inc) * MULT + inc)          # constructor bump
    each draw: out = xsh_rr(state); state = state * MULT + inc

Uniform floats follow the reference convention ``u = out * (1/(2^32-1))``
(reference: Raytracer.h invmax, Vector.h:596).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# PCG multiplier / default increment, split into 32-bit halves.
# numpy scalars, NOT jnp: module-level jnp constants initialize the JAX
# backend at import time, before callers can select a platform.
_MULT = 6364136223846793005  # 0x5851F42D4C957F2D
_MULT_HI = np.uint32(_MULT >> 32)
_MULT_LO = np.uint32(_MULT & 0xFFFFFFFF)

_U16 = np.uint32(0xFFFF)

INV_UINT32_MAX = np.float32(1.0 / 4294967295.0)  # reference invmax


def _mulhi32(a, b):
    """High 32 bits of the 32x32->64 unsigned product, via 16-bit limbs."""
    a_lo = a & _U16
    a_hi = a >> 16
    b_lo = b & _U16
    b_hi = b >> 16
    t = a_lo * b_lo
    mid1 = a_hi * b_lo + (t >> 16)
    mid2 = a_lo * b_hi + (mid1 & _U16)
    return a_hi * b_hi + (mid1 >> 16) + (mid2 >> 16)


def _add64(a_hi, a_lo, b_hi, b_lo):
    """(a + b) mod 2^64 on uint32 pairs."""
    lo = a_lo + b_lo
    carry = (lo < a_lo).astype(jnp.uint32)
    hi = a_hi + b_hi + carry
    return hi, lo


def _mul64(a_hi, a_lo, b_hi, b_lo):
    """(a * b) mod 2^64 on uint32 pairs."""
    lo = a_lo * b_lo
    hi = _mulhi32(a_lo, b_lo) + a_lo * b_hi + a_hi * b_lo
    return hi, lo


def pcg32_bump(state_hi, state_lo, inc_hi, inc_lo):
    """state * MULT + inc (reference: pcg_random.hpp:413-416)."""
    hi, lo = _mul64(state_hi, state_lo, _MULT_HI, _MULT_LO)
    return _add64(hi, lo, inc_hi, inc_lo)


def _xsh_rr(state_hi, state_lo):
    """PCG XSH-RR output: rotr32((state ^ (state>>18)) >> 27, state >> 59)."""
    # state >> 18, as uint32 pair
    s18_hi = state_hi >> 18
    s18_lo = (state_hi << 14) | (state_lo >> 18)
    x_hi = s18_hi ^ state_hi
    x_lo = s18_lo ^ state_lo
    # (x >> 27) truncated to 32 bits
    xorshifted = (x_hi << 5) | (x_lo >> 27)
    rot = state_hi >> 27  # bits 59..63 of the 64-bit state
    # rotr32 — (32 - rot) & 31 handles rot == 0
    return (xorshifted >> rot) | (xorshifted << ((jnp.uint32(32) - rot) & jnp.uint32(31)))


def make_stream(key_hi, key_lo):
    """Seed per-lane PCG32 streams: pcg32(initstate=key, initseq=key).

    Follows the two-arg pcg_random.hpp constructor (pcg_random.hpp:495-499):
    inc = (seq << 1) | 1;  state = bump(seed + inc).

    Args:
      key_hi, key_lo: uint32 arrays (broadcastable) — the 64-bit stream key.
    Returns:
      (state_hi, state_lo, inc_hi, inc_lo) uint32 arrays.
    """
    key_hi = jnp.asarray(key_hi, jnp.uint32)
    key_lo = jnp.asarray(key_lo, jnp.uint32)
    inc_hi = (key_hi << 1) | (key_lo >> 31)
    inc_lo = (key_lo << 1) | jnp.uint32(1)
    s_hi, s_lo = _add64(key_hi, key_lo, inc_hi, inc_lo)
    s_hi, s_lo = pcg32_bump(s_hi, s_lo, inc_hi, inc_lo)
    return s_hi, s_lo, inc_hi, inc_lo


def next_uint32(state):
    """Draw one uint32 from each lane. state = (s_hi, s_lo, inc_hi, inc_lo).

    PCG emits the output of the *current* state, then advances
    (output_previous=true engines, pcg_random.hpp:423-434).
    Returns (out_uint32, new_state).
    """
    s_hi, s_lo, inc_hi, inc_lo = state
    out = _xsh_rr(s_hi, s_lo)
    n_hi, n_lo = pcg32_bump(s_hi, s_lo, inc_hi, inc_lo)
    return out, (n_hi, n_lo, inc_hi, inc_lo)


def next_uniform(state, gate=None):
    """Draw one uniform float in [0,1] per lane: out * (1/(2^32-1)).

    If ``gate`` (bool array) is given, lanes where gate is False do NOT
    consume the draw — their stream state is left untouched.  This reproduces
    the reference's data-dependent draw counts (e.g. the Fresnel RR uniform is
    only drawn on transparent surfaces) while staying fully traced.
    """
    out, new_state = next_uint32(state)
    if gate is not None:
        new_state = tuple(
            jnp.where(gate, n, o) for n, o in zip(new_state, state)
        )
    return out.astype(jnp.float32) * INV_UINT32_MAX, new_state


def next_uniform2(state, gate=None):
    """Two sequential uniforms per lane (common r1, r2 pattern)."""
    u1, state = next_uniform(state, gate)
    u2, state = next_uniform(state, gate)
    return u1, u2, state

"""Packed binary descriptor utilities.

Descriptors are [N, desc_bits//32] uint32.  The unpacked {0,1} float form is
what the matmul consumes for Hamming matching (match.py) and what the landmark
store accumulates for bit-majority representative descriptors (mapstore.py,
replacing CMap's O(obs^2) Hamming medoid — the TODO at CMap.cpp:344)."""

from __future__ import annotations

import jax
import jax.numpy as jnp


def unpack_bits(packed: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """[..., W] uint32 -> [..., W*32] float in {0, 1}.  Bit b of word w
    maps to output position w*32 + b (LSB-first).  dtype=bfloat16 is exact
    for {0,1} bitplanes and halves the HBM traffic of the matmul-matcher's
    operands (inner products accumulate in f32 via
    preferred_element_type)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (packed[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 32).astype(
        dtype)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """[..., B] bool/float in {0,1} -> [..., B//32] uint32 (LSB-first)."""
    b = bits.reshape(*bits.shape[:-1], bits.shape[-1] // 32, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = jnp.sum(b.astype(jnp.uint32) << shifts, axis=-1, dtype=jnp.uint32)
    return words


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Pairwise Hamming distances [N, M] via one matmul.

    d(a, b) = |a| + |b| - 2 a.b  on unpacked {0,1} vectors.  bf16 operands
    are exact for bitplanes; f32 accumulate is exact for descriptor widths
    < 2^24.  This replaces the brute-force Hamming matcher loops
    (brisk::BruteForceMatcher, CTracker.cpp:117)."""
    a = unpack_bits(desc_a, jnp.bfloat16)
    b = unpack_bits(desc_b, jnp.bfloat16)
    pop_a = jnp.sum(a, axis=-1, dtype=jnp.float32)
    pop_b = jnp.sum(b, axis=-1, dtype=jnp.float32)
    inner = jax.lax.dot_general(
        a, b, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)
    return pop_a[:, None] + pop_b[None, :] - 2.0 * inner


def hamming_pairwise(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise Hamming distance between aligned rows [N, W] -> [N]."""
    x = jnp.bitwise_xor(desc_a, desc_b)
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.float32)

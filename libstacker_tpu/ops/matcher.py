"""Brute-force Hamming 2-NN matching + Lowe ratio filtering.

Device counterpart of ``BFMatcher(NORM_HAMMING, crossCheck=false)``
``knn_match(k=2)`` plus the reference's ratio/sort/keep-ratio filter
(SURVEY.md N1/N2; ref src/lib.rs:208-242, 435-480).

Design: 256-bit binary descriptors are unpacked to {0,1} vectors so the
Hamming distance matrix becomes one matrix product via the identity
``popcount(a XOR b) = |a| + |b| - 2 a.b``.  All keypoint sets are
fixed-capacity with validity masks (JAX static shapes), so a whole burst
matches in one fused program.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST
_BIG = np.float32(1e9)  # numpy scalar: no backend init at import


class KnnMatches(NamedTuple):
    train_idx: jnp.ndarray  # [Q, 2] int32 — best / second-best train index
    distance: jnp.ndarray  # [Q, 2] float32 — Hamming distances
    valid: jnp.ndarray  # [Q] bool — both neighbours exist


def unpack_descriptor_bits(desc_u8: jnp.ndarray) -> jnp.ndarray:
    """[..., K, 32] uint8 -> [..., K, 256] float32 of {0,1} bits.

    Bit order is LSB-first within each byte (matches how the ORB
    descriptor packs its comparisons; only consistency matters for
    Hamming distances).
    """
    bits = jnp.unpackbits(desc_u8, axis=-1, bitorder="little")
    return bits.astype(jnp.float32)


def hamming_distance_matrix(
    query_bits: jnp.ndarray, train_bits: jnp.ndarray
) -> jnp.ndarray:
    """[Q,256] x [T,256] {0,1} -> [Q,T] float32 Hamming distances via the
    XOR-popcount-as-matmul identity (one matrix product)."""
    q_pop = jnp.sum(query_bits, axis=-1, keepdims=True)
    t_pop = jnp.sum(train_bits, axis=-1, keepdims=True)
    dot = jnp.matmul(query_bits, train_bits.T, precision=_HIGHEST)
    return q_pop + t_pop.T - 2.0 * dot


def knn_match2(
    query_desc: jnp.ndarray,
    train_desc: jnp.ndarray,
    query_valid: jnp.ndarray,
    train_valid: jnp.ndarray,
) -> KnnMatches:
    """2-NN Hamming matching with validity masks.

    ``query_desc``/``train_desc``: [Q,32]/[T,32] uint8.
    Invalid train columns get +inf distance; a query is valid when it is
    itself valid and at least two valid train descriptors exist
    (BFMatcher only emits pairs it can fill, ref src/lib.rs:221-230
    requires m.len() == 2).
    """
    qb = unpack_descriptor_bits(query_desc)
    tb = unpack_descriptor_bits(train_desc)
    dist = hamming_distance_matrix(qb, tb)
    dist = jnp.where(train_valid[None, :], dist, _BIG)
    # top-2 smallest
    neg_top, idx = jax.lax.top_k(-dist, 2)
    top = -neg_top
    n_train = jnp.sum(train_valid.astype(jnp.int32))
    valid = query_valid & (n_train >= 2)
    return KnnMatches(
        train_idx=idx.astype(jnp.int32), distance=top.astype(jnp.float32),
        valid=valid,
    )


class FilteredMatches(NamedTuple):
    query_idx: jnp.ndarray  # [Q] int32, sorted by distance (padded tail)
    train_idx: jnp.ndarray  # [Q] int32
    distance: jnp.ndarray  # [Q] float32
    keep: jnp.ndarray  # [Q] bool — survives ratio test + keep-ratio cut
    count: jnp.ndarray  # [] int32 — number kept


def ratio_filter_sort_keep(
    matches: KnnMatches,
    match_ratio: float,
    match_keep_ratio: float,
) -> FilteredMatches:
    """Lowe ratio test, sort by distance, keep best round(n*keep_ratio)
    (ref src/lib.rs:221-236): masked/padded equivalent with stable
    index tie-breaking for reproducibility (SURVEY.md §7 hard part e)."""
    d0 = matches.distance[:, 0]
    d1 = matches.distance[:, 1]
    pass_ratio = matches.valid & (d0 < match_ratio * d1)
    q = d0.shape[0]
    qidx = jnp.arange(q, dtype=jnp.int32)
    sort_key = jnp.where(pass_ratio, d0, _BIG)
    # stable sort: secondary key = query index (jnp.lexsort is stable)
    order = jnp.lexsort((qidx, sort_key))
    d_sorted = sort_key[order]
    n_pass = jnp.sum(pass_ratio.astype(jnp.int32))
    # Rust: (len as f32 * keep_ratio).round() — half away from zero
    n_keep = jnp.floor(
        n_pass.astype(jnp.float32) * jnp.float32(match_keep_ratio) + 0.5
    ).astype(jnp.int32)
    rank = jnp.arange(q, dtype=jnp.int32)
    keep = (rank < n_keep) & (d_sorted < _BIG)
    return FilteredMatches(
        query_idx=qidx[order],
        train_idx=matches.train_idx[:, 0][order],
        distance=d_sorted,
        keep=keep,
        count=jnp.sum(keep.astype(jnp.int32)),
    )

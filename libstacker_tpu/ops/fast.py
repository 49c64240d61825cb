"""FAST-9/16 corner detection + Harris responses, fully vectorised.

Part of the device ORB stack (SURVEY.md N4; the reference calls
OpenCV's ``ORB::detect_and_compute`` at src/utils.rs:174-183).  The
segment test, corner score and 3x3 non-max suppression are dense
elementwise programs over the whole image (VPU work, XLA-fused) instead
of OpenCV's per-pixel branchy C++.

Semantics matched to OpenCV FAST (type 9_16, nonmaxSuppression=true):
- corner test: some contiguous arc of 9 of the 16 Bresenham-circle
  pixels is entirely brighter than center+t or darker than center-t;
- score: max over arcs of the min absolute arc difference, minus 1
  (cornerScore<16>); arc minima computed by log-doubling over the
  circular axis;
- NMS: strictly greater than all 8 neighbour scores.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3, in circular order (OpenCV pixel order).
CIRCLE_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)


def fast_score(
    img: jnp.ndarray, threshold: int = 20
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """FAST-9/16 on ``[H, W]`` (uint8 or float).

    Returns (corner_mask [H,W] bool, score [H,W] float32) before NMS.
    Pixels within 3 of the border are never corners (OpenCV skips them).

    XLA-fusion-friendly formulation: the 16 circle neighbours are STATIC
    slices of one edge-padded buffer and the arc min/max tree is a
    Python-level list rotation — pure elementwise chains the compiler
    fuses into a couple of passes over HBM.  (The previous jnp.roll +
    stacked-[16,H,W] form materialised ~40 image-sized buffers and made
    4K detection HBM-bound enough to require host chunking.)

    Integer (uint8) inputs compute the tree in bfloat16: every value is
    an integer difference in [-255, 255] and bf16 represents integers up
    to |256| exactly, so the result is BIT-IDENTICAL to f32 while the
    materialised arc intermediates move half the HBM bytes.  Float
    inputs (fractional intensities) stay f32.
    """
    exact_small_int = jnp.issubdtype(img.dtype, jnp.integer)
    dt = jnp.bfloat16 if exact_small_int else jnp.float32
    x = img.astype(dt)
    h, w = x.shape[-2], x.shape[-1]
    t = jnp.asarray(threshold, dt)

    xp = jnp.pad(x, 3, mode="edge")  # border pixels are masked below
    e = [
        jax.lax.slice(xp, (3 + dy, 3 + dx), (3 + dy + h, 3 + dx + w)) - x
        for (dx, dy) in CIRCLE_OFFSETS
    ]  # 16 x [H, W]; e[k] > 0 where neighbour k is brighter

    def arc9_min(v):
        # min over circular windows of length 9 starting at each k.
        # Default: log-doubling with list rotation (3 stages x 16
        # intermediate images).  LIBSTACKER_FAST_TREE=2stage uses a
        # width-3-then-skip-3 association instead (2 stages x 16
        # intermediates — XLA cost analysis says the tree intermediates
        # dominate fast_detect's 1.66 GB of HBM traffic at 4K; min is
        # exact, so both forms are BIT-IDENTICAL).  Hardware A/B knob.
        import os

        tree = os.environ.get("LIBSTACKER_FAST_TREE")
        if tree == "noshare":
            # Zero shared subexpressions: each arc is its own 8-min
            # chain with single-consumer intermediates, so XLA can fuse
            # the whole segment test into one pass over the padded
            # image instead of materialising the w2/w4/w8 stages
            # (recompute-over-materialise: ~2x the min ops, ~none of
            # the tree's HBM traffic).  min is exact -> bit-identical.
            out = []
            for i in range(16):
                m = v[i % 16]
                for j in range(1, 9):
                    m = jnp.minimum(m, v[(i + j) % 16])
                out.append(m)
            return out
        if tree == "2stage":
            w3 = [
                jnp.minimum(jnp.minimum(v[i], v[(i + 1) % 16]),
                            v[(i + 2) % 16])
                for i in range(16)
            ]
            return [
                jnp.minimum(
                    jnp.minimum(w3[i], w3[(i + 3) % 16]), w3[(i + 6) % 16]
                )
                for i in range(16)
            ]
        w2 = [jnp.minimum(v[i], v[(i + 1) % 16]) for i in range(16)]
        w4 = [jnp.minimum(w2[i], w2[(i + 2) % 16]) for i in range(16)]
        w8 = [jnp.minimum(w4[i], w4[(i + 4) % 16]) for i in range(16)]
        return [jnp.minimum(w8[i], v[(i + 8) % 16]) for i in range(16)]

    def list_max(v):
        while len(v) > 1:
            v = [
                jnp.maximum(v[i], v[i + len(v) // 2])
                for i in range(len(v) // 2)
            ] + (v[len(v) - 1 :] if len(v) % 2 else [])
            # (len is always a power of two here: 16 -> 8 -> 4 -> 2 -> 1)
        return v[0]

    tb = list_max(arc9_min(e))  # bright-arc strength
    td = list_max(arc9_min([-ei for ei in e]))  # dark-arc strength
    corner = (tb > t) | (td > t)
    score = jnp.maximum(tb, td).astype(jnp.float32) - 1.0

    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    corner = corner & interior
    return corner, jnp.where(corner, score, 0.0)


def fast_detect(
    img: jnp.ndarray, threshold: int = 20, nonmax: bool = True
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """FAST with 3x3 non-max suppression.  Returns (mask, score)."""
    corner, score = fast_score(img, threshold)
    if not nonmax:
        return corner, score
    h, w = score.shape
    # uint8 images have integer scores in [-1, 254]; bf16 represents
    # integers up to |256| exactly, so the neighbour-max compare is
    # bit-identical while the 8 padded slices move half the bytes
    nms_dt = (
        jnp.bfloat16 if jnp.issubdtype(img.dtype, jnp.integer)
        else jnp.float32
    )
    sc = score.astype(nms_dt)
    sp = jnp.pad(sc, 1)  # zero pad: scores are >= 0, borders masked
    neigh = [
        jax.lax.slice(sp, (1 + dy, 1 + dx), (1 + dy + h, 1 + dx + w))
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
        if (dy, dx) != (0, 0)
    ]
    nmax = neigh[0]
    for nb in neigh[1:]:
        nmax = jnp.maximum(nmax, nb)
    keep = corner & (sc > nmax)
    return keep, jnp.where(keep, score, 0.0)


class TopKeypoints(NamedTuple):
    ys: jnp.ndarray  # [K] int32
    xs: jnp.ndarray  # [K] int32
    score: jnp.ndarray  # [K] float32
    valid: jnp.ndarray  # [K] bool


def top_k_keypoints(
    mask: jnp.ndarray, score: jnp.ndarray, k: int, approx: bool = True
) -> TopKeypoints:
    """Select the k highest-score masked pixels (ties broken by raster
    order, mirroring OpenCV's stable retainBest ordering closely
    enough for statistical parity).

    ``approx=True`` uses ``lax.approx_max_k`` (its recall loss here is
    ~1-2% of *candidates*, before Harris re-ranking; on GPU and CPU
    backends XLA lowers it to an exact sort and slice).

    LIBSTACKER_TOPK=pooled routes approximate requests through
    :func:`top_k_keypoints_nms` (hardware A/B knob).  Only valid when
    the callers' score maps are 3x3 non-max suppressed — true for both
    FAST paths in ops/orb.py.  Explicit ``approx=False`` calls (exact
    oracle comparisons) are never rerouted."""
    import os

    if approx and os.environ.get("LIBSTACKER_TOPK") == "pooled":
        return top_k_keypoints_nms(mask, score, k)
    h, w = score.shape
    flat = jnp.where(mask, score, -1.0).reshape(-1)
    if approx:
        vals, idx = jax.lax.approx_max_k(flat, k)
    else:
        vals, idx = jax.lax.top_k(flat, k)
    ys = (idx // w).astype(jnp.int32)
    xs = (idx % w).astype(jnp.int32)
    return TopKeypoints(ys=ys, xs=xs, score=vals, valid=vals > 0.0)


def top_k_keypoints_nms(
    mask: jnp.ndarray, score: jnp.ndarray, k: int
) -> TopKeypoints:
    """Exact-reduction top-k for 3x3 NON-MAX-SUPPRESSED score maps.

    Strict 3x3 NMS leaves survivors pairwise more than 1 px apart
    (Chebyshev), so any 2x2 block holds AT MOST ONE survivor and a 2x2
    max-pool is a LOSSLESS 4x reduction: the pooled array has exactly
    the survivors' values (plus -1 filler).  The top-k scan then runs
    over H*W/4 elements instead of H*W, and ``approx_max_k``'s binned
    recall IMPROVES at equal k (fewer elements per bin).  Positions are
    recovered by comparing the 4 original pixels of each selected
    block (k x 4 gather); intra-block argmax takes the first maximum in
    raster order, matching the flat path's tie behavior.

    NOT valid for arbitrary score maps (two adjacent maxima would
    collapse into one pooled value and the second would be lost)."""
    h, w = score.shape
    m = jnp.where(mask, score, -1.0)
    he, we = -(-h // 2) * 2, -(-w // 2) * 2
    if (he, we) != (h, w):
        m = jnp.pad(m, ((0, he - h), (0, we - w)), constant_values=-1.0)
    pooled = m.reshape(he // 2, 2, we // 2, 2).max(axis=(1, 3)).reshape(-1)
    kk = min(k, pooled.shape[0])
    vals, pidx = jax.lax.approx_max_k(pooled, kk)
    if kk < k:  # keep the static [k] slot shape of the flat path
        vals = jnp.pad(vals, (0, k - kk), constant_values=-1.0)
        pidx = jnp.pad(pidx, (0, k - kk))
    by = (pidx // (we // 2)) * 2
    bx = (pidx % (we // 2)) * 2
    cand = jnp.stack(
        [m[by, bx], m[by, bx + 1], m[by + 1, bx], m[by + 1, bx + 1]],
        axis=1,
    )  # [k, 4] — block pixels in raster order
    sub = jnp.argmax(cand, axis=1).astype(jnp.int32)
    ys = (by + sub // 2).astype(jnp.int32)
    xs = (bx + sub % 2).astype(jnp.int32)
    return TopKeypoints(ys=ys, xs=xs, score=vals, valid=vals > 0.0)


def harris_from_patches(
    patch: jnp.ndarray, block_size: int = 7, harris_k: float = 0.04
) -> jnp.ndarray:
    """Harris response from [K, b+2, b+2] pixel patches, matching ORB's
    HarrisResponses (orb.cpp): 3x3 Sobel gradients
    (Ix = 2*(p[x+1]-p[x-1]) + the two diagonal row differences),
    7x7 block sums, response = (ab - c^2 - k (a+b)^2) * (1/(4*7*255))^4."""
    dx = patch[:, :, 2:] - patch[:, :, :-2]  # [K, b+2, b]
    dy = patch[:, 2:, :] - patch[:, :-2, :]  # [K, b, b+2]
    ix = 2.0 * dx[:, 1:-1, :] + dx[:, :-2, :] + dx[:, 2:, :]
    iy = 2.0 * dy[:, :, 1:-1] + dy[:, :, :-2] + dy[:, :, 2:]
    a = jnp.sum(ix * ix, axis=(1, 2))
    b = jnp.sum(iy * iy, axis=(1, 2))
    c = jnp.sum(ix * iy, axis=(1, 2))
    scale = 1.0 / (4.0 * block_size * 255.0)
    scale_sq_sq = scale * scale * scale * scale
    return (a * b - c * c - harris_k * (a + b) ** 2) * scale_sq_sq


def harris_response_at(
    img: jnp.ndarray,
    ys: jnp.ndarray,
    xs: jnp.ndarray,
    block_size: int = 7,
    harris_k: float = 0.04,
) -> jnp.ndarray:
    """Harris corner response at given pixel locations (gather form;
    the ORB pipeline computes the same thing from its Pallas-extracted
    patches — see :func:`harris_from_patches`)."""
    x = img.astype(jnp.float32)
    r = block_size // 2
    # patch of (block+2)^2 around each kp for gradient support
    offs = jnp.arange(-r - 1, r + 2)
    py = ys[:, None, None] + offs[None, :, None]
    px = xs[:, None, None] + offs[None, None, :]
    h, w = x.shape
    py = jnp.clip(py, 0, h - 1)
    px = jnp.clip(px, 0, w - 1)
    patch = x[py, px]  # [K, b+2, b+2]
    return harris_from_patches(patch, block_size, harris_k)

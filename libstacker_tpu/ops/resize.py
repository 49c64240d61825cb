"""Resize ops (INTER_AREA / INTER_LINEAR / INTER_NEAREST) as matmuls.

The reference's ``scale_image`` helper (src/utils.rs:186-214) shrinks with
``imgproc::resize`` INTER_AREA so that the **smaller** of (width, height)
equals ``scale_down`` (despite its docs saying "width" — see
src/utils.rs:192-196).  ORB's pyramid uses INTER_LINEAR.

Design: both area-averaging and bilinear resize are *separable* linear
maps, so we materialise per-axis weight matrices on host (cached) and
apply them as two dense matmuls instead of a scatter/gather loop, and XLA fuses the pair.  Weight construction
reproduces OpenCV semantics:

- INTER_AREA: each dst pixel averages the exact fractional source span
  ``[x*scale, (x+1)*scale)`` (for enlargement the span covers <= 2 taps;
  this matches cv2's zoom path exactly, verified by operator probing).
- INTER_LINEAR: src coord = (dst + 0.5) * scale - 0.5, edge-clamped.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..errors import InvalidParamsError


@functools.lru_cache(maxsize=256)
def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] float32 area-averaging weights (true INTER_AREA shrink)."""
    scale = src / dst
    w = np.zeros((dst, src), dtype=np.float64)
    inv = 1.0 / scale
    for x in range(dst):
        f0 = x * scale
        f1 = min(f0 + scale, float(src))
        j0 = int(math.floor(f0))
        j1 = int(math.ceil(f1))
        for j in range(j0, min(j1, src)):
            overlap = min(j + 1.0, f1) - max(float(j), f0)
            if overlap > 0:
                w[x, j] = overlap * inv
    # Normalise rows to guard against float drift at the right edge.
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _linear_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] float32 bilinear weights with OpenCV coordinate mapping."""
    scale = src / dst
    w = np.zeros((dst, src), dtype=np.float64)
    for x in range(dst):
        fx = (x + 0.5) * scale - 0.5
        sx = int(math.floor(fx))
        frac = fx - sx
        if sx < 0:
            sx, frac = 0, 0.0
        if sx >= src - 1:
            sx, frac = src - 2, 1.0
        if src == 1:
            w[x, 0] = 1.0
        else:
            w[x, sx] += 1.0 - frac
            w[x, sx + 1] += frac
    return w.astype(np.float32)


_BLOCK = 128  # output rows/cols per banded block (lane width)


@functools.lru_cache(maxsize=256)
def _banded_weights(src: int, dst: int, interpolation: int):
    """Block-banded factorisation of the [dst, src] resize weight matrix.

    Both INTER_AREA and INTER_LINEAR weight matrices are banded (each
    output pixel reads a short contiguous source span), so the dense
    ``[dst, src]`` matmul wastes ~src/band of its FLOPs multiplying
    exact zeros.  Group outputs into blocks of ``_BLOCK``; block ``g``
    only needs source window ``[base[g], base[g]+L)`` where
    ``L ~ _BLOCK * scale + 2``.  The product of the windowed blocks is
    bit-identical to the dense matmul (the extra taps have weight 0.0
    and f32 adds of 0.0 are exact) at ~src/L times fewer FLOPs.

    Returns ``(bases, L, w)`` with ``bases`` an int tuple per block and
    ``w`` a ``[nblk, _BLOCK, L]`` float32 array (rows past ``dst`` are
    zero padding).
    """
    if interpolation == constants.INTER_AREA:
        full = _area_weights(src, dst)
    else:
        full = _linear_weights(src, dst)
    nblk = -(-dst // _BLOCK)
    spans = []
    for g in range(nblk):
        rows = full[g * _BLOCK : (g + 1) * _BLOCK]
        cols = np.nonzero(rows.any(axis=0))[0]
        spans.append((int(cols[0]), int(cols[-1]) + 1))
    L = max(hi - lo for lo, hi in spans)
    bases = []
    w = np.zeros((nblk, _BLOCK, L), dtype=np.float32)
    for g, (lo, hi) in enumerate(spans):
        base = min(lo, src - L)
        rows = full[g * _BLOCK : (g + 1) * _BLOCK, base : base + L]
        w[g, : rows.shape[0]] = rows
        bases.append(base)
    return tuple(bases), L, w


def _apply_axis_banded(x: jnp.ndarray, axis: int, src: int, dst: int,
                       interpolation: int) -> jnp.ndarray:
    """Resize one axis via the block-banded matmul (bit-exact with the
    dense einsum, ~src/L fewer FLOPs).  Falls back to dense for tiny
    sizes where blocking buys nothing."""
    bases, L, w = _banded_weights(src, dst, interpolation)
    axis = axis % x.ndim
    # Move the resized axis to the front for uniform slicing/einsum.
    xt = jnp.moveaxis(x, axis, 0)
    blocks = jnp.stack([
        jax.lax.slice_in_dim(xt, b, b + L, axis=0) for b in bases
    ])  # [nblk, L, ...]
    out = jnp.einsum(
        "gol,gl...->go...", jnp.asarray(w), blocks, precision="highest"
    )  # [nblk, _BLOCK, ...]
    out = out.reshape((len(bases) * _BLOCK,) + out.shape[2:])[:dst]
    return jnp.moveaxis(out, 0, axis)


@functools.lru_cache(maxsize=256)
def _nearest_index(src: int, dst: int) -> np.ndarray:
    scale = src / dst
    idx = np.minimum(np.floor(np.arange(dst) * scale), src - 1).astype(np.int32)
    return idx


def resize(
    img: jnp.ndarray,
    dsize: Tuple[int, int],
    interpolation: int = constants.INTER_LINEAR,
) -> jnp.ndarray:
    """Resize ``[..., H, W]`` or ``[..., H, W, C]`` to ``dsize=(h, w)``.

    Float inputs stay float; uint8 inputs are computed in f32 and rounded
    back to uint8 (OpenCV's fixed-point path agrees within 1 LSB).
    """
    dh, dw = int(dsize[0]), int(dsize[1])
    has_channels = img.ndim >= 3 and img.shape[-1] <= 4
    if has_channels:
        sh, sw = img.shape[-3], img.shape[-2]
    else:
        sh, sw = img.shape[-2], img.shape[-1]
    if dh <= 0 or dw <= 0:
        raise InvalidParamsError(f"invalid dsize {dsize}")

    in_dtype = img.dtype
    if interpolation == constants.INTER_NEAREST:
        yi = jnp.asarray(_nearest_index(sh, dh))
        xi = jnp.asarray(_nearest_index(sw, dw))
        if has_channels:
            return img[..., yi, :, :][..., :, xi, :]
        return img[..., yi, :][..., :, xi]

    if interpolation == constants.INTER_AREA:
        # True fractional area weighting on both axes; for upscale the
        # source span is shorter than a pixel and covers <= 2 taps, which
        # is exactly what cv2's INTER_AREA zoom path computes (verified
        # against cv2 5.0 by operator probing in tests).
        wy, wx = _area_weights(sh, dh), _area_weights(sw, dw)
    elif interpolation == constants.INTER_LINEAR:
        wy, wx = _linear_weights(sh, dh), _linear_weights(sw, dw)
    else:
        raise InvalidParamsError(f"unsupported interpolation {interpolation}")

    x = img.astype(jnp.float32)
    row_axis = -3 if has_channels else -2
    col_axis = -2 if has_channels else -1

    def _one_axis(x, axis, src, dst, w_full):
        # Prefer the block-banded matmul (same result, ~src/L fewer
        # FLOPs); fall back to the dense matrix when the band covers
        # the whole source (tiny images / extreme upscale).
        bases, L, _ = _banded_weights(src, dst, interpolation)
        if L < src and dst > _BLOCK // 2:
            return _apply_axis_banded(x, axis, src, dst, interpolation)
        xt = jnp.moveaxis(x, axis % x.ndim, 0)
        out = jnp.einsum(
            "ay,y...->a...", jnp.asarray(w_full), xt, precision="highest"
        )
        return jnp.moveaxis(out, 0, axis % x.ndim)

    out = _one_axis(x, row_axis, sh, dh, wy)
    out = _one_axis(out, col_axis, sw, dw, wx)
    if in_dtype == jnp.uint8:
        out = jnp.clip(jnp.floor(out + 0.5), 0, 255).astype(jnp.uint8)
    else:
        out = out.astype(in_dtype)
    return out


def scale_image_size(height: int, width: int, scale_down: float) -> Tuple[int, int]:
    """New (h, w) for ``scale_image``: scales so the *smaller* dimension
    equals ``scale_down`` (ref src/utils.rs:192-199, including the
    truncating ``as i32`` casts)."""
    if width < height:
        factor = float(scale_down) / float(width)
    else:
        factor = float(scale_down) / float(height)
    return int(height * factor), int(width * factor)


def scale_image(img: jnp.ndarray, scale_down: float) -> jnp.ndarray:
    """INTER_AREA rescale with the reference's smaller-dimension semantics
    (ref src/utils.rs:186-214)."""
    has_channels = img.ndim >= 3 and img.shape[-1] <= 4
    if has_channels:
        h, w = img.shape[-3], img.shape[-2]
    else:
        h, w = img.shape[-2], img.shape[-1]
    nh, nw = scale_image_size(h, w, scale_down)
    return resize(img, (nh, nw), constants.INTER_AREA)

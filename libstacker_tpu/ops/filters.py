"""Separable correlation filters with OpenCV border semantics.

Device replacements for the OpenCV filter calls used by the
reference's sharpness metrics and the ECC engine (SURVEY.md N12-N14):
``sep_filter_2d`` (src/lib.rs:1038-1061), ``laplacian``
(src/lib.rs:1076-1084), ``sobel`` (src/lib.rs:1111-1132), plus the
Gaussian kernels OpenCV builds internally (``get_gaussian_kernel``,
``GaussianBlur``).

Design: small (<=7 tap) separable kernels are applied as unrolled
shift-multiply-adds over a border-padded image — pure VPU work that XLA
fuses into neighbouring ops; no im2col, no gather.  Everything operates
on the trailing two axes so a whole ``[N,H,W]`` burst filters in one
program.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

_PAD_MODE = {
    "constant": "constant",
    "replicate": "edge",
    "reflect101": "reflect",  # OpenCV BORDER_REFLECT_101  gfedcb|abcdefgh|gfedcba
    "reflect": "symmetric",  # OpenCV BORDER_REFLECT      fedcba|abcdefgh|hgfedcb
    "wrap": "wrap",
}


def pad2d(
    img: jnp.ndarray,
    pad_y: int,
    pad_x: int,
    border: str = "reflect101",
    value: float = 0.0,
) -> jnp.ndarray:
    """Pad the trailing two axes with an OpenCV border mode."""
    if pad_y == 0 and pad_x == 0:
        return img
    pads = [(0, 0)] * (img.ndim - 2) + [(pad_y, pad_y), (pad_x, pad_x)]
    mode = _PAD_MODE[border]
    if mode == "constant":
        return jnp.pad(img, pads, mode="constant", constant_values=value)
    return jnp.pad(img, pads, mode=mode)


def _correlate_axis(img: jnp.ndarray, kernel: Sequence[float], axis: int) -> jnp.ndarray:
    """Correlate a pre-padded image along ``axis`` (-1 or -2) with a 1D
    kernel, producing the valid region."""
    k = len(kernel)
    size = img.shape[axis] - (k - 1)
    out = None
    for i, c in enumerate(kernel):
        if c == 0.0:
            continue
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(i, i + size)
        term = img[tuple(sl)] * c
        out = term if out is None else out + term
    if out is None:
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(0, size)
        out = jnp.zeros_like(img[tuple(sl)])
    return out


def sep_filter2d(
    img: jnp.ndarray,
    kx: Sequence[float],
    ky: Sequence[float],
    border: str = "reflect101",
    value: float = 0.0,
) -> jnp.ndarray:
    """OpenCV sepFilter2D (correlation, centred anchor): ``kx`` runs
    horizontally (along W), ``ky`` vertically (along H).  Operates on
    ``[..., H, W]``."""
    ry, rx = len(ky) // 2, len(kx) // 2
    p = pad2d(img, ry, rx, border, value)
    out = _correlate_axis(p, list(kx), axis=-1)
    out = _correlate_axis(out, list(ky), axis=-2)
    return out


@functools.lru_cache(maxsize=64)
def gaussian_kernel(ksize: int, sigma: float = 0.0) -> Tuple[float, ...]:
    """OpenCV getGaussianKernel: fixed small tables for ksize<=9 when
    sigma<=0 (cv2 5.x extends the table to 9 with /256 fixed-point
    values), else sampled exponential with OpenCV's derived sigma."""
    small_tab = {
        1: (1.0,),
        3: (0.25, 0.5, 0.25),
        5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
        7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
        9: (
            0.015625, 0.05078125, 0.1171875, 0.19921875, 0.234375,
            0.19921875, 0.1171875, 0.05078125, 0.015625,
        ),
    }
    if sigma <= 0 and ksize in small_tab:
        return small_tab[ksize]
    s = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs * xs) / (2.0 * s * s))
    k /= k.sum()
    return tuple(k.tolist())


def gaussian_blur(
    img: jnp.ndarray, ksize: int, sigma: float = 0.0, border: str = "reflect101"
) -> jnp.ndarray:
    """OpenCV GaussianBlur(ksize, sigmaX=sigma, sigmaY=sigma)."""
    k = gaussian_kernel(ksize, sigma)
    return sep_filter2d(img, k, k, border)


@functools.lru_cache(maxsize=64)
def deriv_kernel(order: int, ksize: int) -> Tuple[float, ...]:
    """OpenCV getDerivKernels 1D factor: binomial smoothing of order
    (ksize-1-order) composed with ``order`` discrete derivatives.
    ksize==1 with order>0 uses a 3-tap kernel (no smoothing)."""
    if ksize == 1 and order > 0:
        ksize = 3
    k = np.array([1.0])
    for _ in range(ksize - 1 - order):
        k = np.convolve(k, [1.0, 1.0])
    for _ in range(order):
        k = np.convolve(k, [-1.0, 1.0])
    return tuple(k.tolist())


def sobel(
    img: jnp.ndarray,
    dx: int,
    dy: int,
    ksize: int = 3,
    scale: float = 1.0,
    border: str = "reflect101",
) -> jnp.ndarray:
    """OpenCV Sobel on ``[..., H, W]`` (ref src/lib.rs:1111-1132)."""
    kx = deriv_kernel(dx, ksize)
    ky = deriv_kernel(dy, ksize)
    out = sep_filter2d(img, kx, ky, border)
    if scale != 1.0:
        out = out * scale
    return out


def laplacian(img: jnp.ndarray, ksize: int = 3, border: str = "replicate") -> jnp.ndarray:
    """OpenCV Laplacian: ksize=1 uses the 4-neighbour stencil; ksize>=3
    sums the two smoothed second derivatives (ref src/lib.rs:1076-1084
    calls it with ksize=3, BORDER_REPLICATE)."""
    if ksize == 1:
        d2 = (1.0, -2.0, 1.0)
        one = (1.0,)
        return sep_filter2d(img, d2, one, border) + sep_filter2d(img, one, d2, border)
    d2x = deriv_kernel(2, ksize)
    sm = deriv_kernel(0, ksize)
    return sep_filter2d(img, d2x, sm, border) + sep_filter2d(img, sm, d2x, border)

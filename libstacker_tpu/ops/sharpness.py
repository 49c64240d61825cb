"""Focus / sharpness metrics as fused conv+reduce programs.

Device counterparts of the reference's four metrics
(SURVEY.md R10-R13):

- LAPM  ``sharpness_modified_laplacian``  (ref src/lib.rs:1032-1070)
- LAPV  ``sharpness_variance_of_laplacian`` (ref src/lib.rs:1074-1090)
- TENG  ``sharpness_tenengrad``            (ref src/lib.rs:1101-1147)
- GLVN  ``sharpness_normalized_gray_level_variance`` (src/lib.rs:1151-1166)

Each metric accepts ``[..., H, W]`` so a whole burst scores in one fused
XLA program (the reference instead fans frames out over Rayon threads,
examples/main.rs:37-49).  Compute is float32;
the OpenCV oracle computes in float64 — parity tests use relative
tolerance accordingly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..errors import InvalidParamsError
from . import filters

_EPS_F64 = 2.220446049250313e-16  # f64::EPSILON used at ref src/lib.rs:1163


def _to_float(img: jnp.ndarray) -> jnp.ndarray:
    if jnp.issubdtype(img.dtype, jnp.floating):
        return img.astype(jnp.float32)
    return img.astype(jnp.float32)


@jax.jit
def sharpness_modified_laplacian(img: jnp.ndarray) -> jnp.ndarray:
    """LAPM (Nayar89): mean(|Lx| + |Ly|) with Lx = sep_filter(kx=[-1,2,-1],
    ky=gauss3) and Ly the transpose pair (ref src/lib.rs:1032-1070)."""
    x = _to_float(img)
    m = (-1.0, 2.0, -1.0)
    g = filters.gaussian_kernel(3, -1.0)
    lx = filters.sep_filter2d(x, m, g, border="reflect101")
    ly = filters.sep_filter2d(x, g, m, border="reflect101")
    return jnp.mean(jnp.abs(lx) + jnp.abs(ly), axis=(-2, -1))


@jax.jit
def sharpness_variance_of_laplacian(img: jnp.ndarray) -> jnp.ndarray:
    """LAPV (Pech2000): variance of the ksize=3 Laplacian with
    BORDER_REPLICATE (ref src/lib.rs:1074-1090; population variance as
    in OpenCV meanStdDev)."""
    x = _to_float(img)
    lap = filters.laplacian(x, ksize=3, border="replicate")
    mu = jnp.mean(lap, axis=(-2, -1), keepdims=True)
    return jnp.mean((lap - mu) ** 2, axis=(-2, -1))


@functools.partial(jax.jit, static_argnames=("k_size",))
def sharpness_tenengrad(img: jnp.ndarray, k_size: int = 3) -> jnp.ndarray:
    """TENG (Krotkov86): mean(gx^2 + gy^2) of Sobel gradients
    (ref src/lib.rs:1101-1147; k_size validated to {1,3,5,7} at
    src/lib.rs:1103-1107)."""
    if k_size not in (1, 3, 5, 7):
        raise InvalidParamsError("Kernel size must be 1, 3, 5, or 7")
    x = _to_float(img)
    gx = filters.sobel(x, 1, 0, ksize=k_size, border="reflect101")
    gy = filters.sobel(x, 0, 1, ksize=k_size, border="reflect101")
    return jnp.mean(gx * gx + gy * gy, axis=(-2, -1))


@jax.jit
def sharpness_normalized_gray_level_variance(img: jnp.ndarray) -> jnp.ndarray:
    """GLVN (Santos97): population variance / mean (mean clamped to eps,
    ref src/lib.rs:1151-1166)."""
    x = _to_float(img)
    mu = jnp.mean(x, axis=(-2, -1), keepdims=True)
    var = jnp.mean((x - mu) ** 2, axis=(-2, -1))
    mu = jnp.maximum(mu[..., 0, 0], _EPS_F64)
    return var / mu


@functools.partial(jax.jit, static_argnames=("teng_k_size",))
def sharpness_all(img: jnp.ndarray, teng_k_size: int = 3):
    """All four metrics over a batch in ONE jitted program (one dispatch
    for the whole scoring pass).  Returns a dict
    with keys lapm/lapv/teng/glvn, each ``[...]`` shaped — the
    device-side equivalent of the example's parallel scoring loop
    (ref examples/main.rs:37-49)."""
    return {
        "lapm": sharpness_modified_laplacian(img),
        "lapv": sharpness_variance_of_laplacian(img),
        "teng": sharpness_tenengrad(img, teng_k_size),
        "glvn": sharpness_normalized_gray_level_variance(img),
    }

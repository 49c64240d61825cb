"""Affine / perspective warps (inverse-map bilinear resampling).

Device counterpart of ``imgproc::warp_perspective`` /
``imgproc::warp_affine`` (SURVEY.md N5/N6; call sites ref
src/lib.rs:291-299, 536-544, 782-802, 964-983): every output pixel is
inverse-mapped through the transform, bilinearly sampled with a
configurable border mode, producing an XLA gather over the source image.

Fidelity notes (matched to OpenCV within 1/32 px):
- OpenCV inverts the given matrix unless WARP_INVERSE_MAP is set; we
  mirror that with ``inverse_map=False`` default.
- OpenCV quantises source coordinates to INTER_TAB_SIZE=32 fractional
  bins; we reproduce that quantisation so per-pixel output agrees with
  the oracle to interpolation tolerance.
- INTER_NEAREST rounds the un-quantised coordinate (used for the ECC
  validity mask).

All functions operate on one image ``[H,W]`` or ``[H,W,C]``; pipelines
``vmap`` them over the frame axis.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax.numpy as jnp

from .. import constants

_INTER_TAB_SIZE = 32.0


def affine_to_3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Promote a 2x3 affine matrix to 3x3."""
    bottom = jnp.array([[0.0, 0.0, 1.0]], dtype=m.dtype)
    return jnp.concatenate([m, bottom], axis=0)


def invert_3x3(m: jnp.ndarray) -> jnp.ndarray:
    return jnp.linalg.inv(m)


def _map_border_index(idx: jnp.ndarray, size: int, border: str) -> jnp.ndarray:
    """OpenCV borderInterpolate for a single axis (non-constant modes)."""
    if border == "replicate":
        return jnp.clip(idx, 0, size - 1)
    if border == "wrap":
        return jnp.mod(idx, size)
    if border == "reflect101":
        if size == 1:
            return jnp.zeros_like(idx)
        period = 2 * (size - 1)
        m = jnp.mod(idx, period)
        return jnp.minimum(m, period - m)
    if border == "reflect":
        period = 2 * size
        m = jnp.mod(idx, period)
        return jnp.where(m >= size, period - 1 - m, m)
    raise ValueError(f"unsupported border mode: {border}")


def _gather2d(img: jnp.ndarray, yi: jnp.ndarray, xi: jnp.ndarray) -> jnp.ndarray:
    """Gather img[yi, xi] for [H,W] or [H,W,C] images with [h,w] index maps."""
    return img[yi, xi]


def _sample_bilinear(
    img: jnp.ndarray,
    sx: jnp.ndarray,
    sy: jnp.ndarray,
    border: str,
    border_value,
    fixed_point_1024: bool = False,
    dst_base: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Bilinear sample img at float coords (sx, sy) [h,w], with OpenCV's
    1/32 fractional quantisation and border handling.

    ``fixed_point_1024``: reproduce warpAffine's AB_BITS=10 fixed-point
    path (coords rounded to 1/1024 px then to 1/32 bins with +16 bias);
    warpPerspective rounds the double-precision coordinate directly to
    1/32 (cvRound).

    ``border == "transparent"`` (cv2.BORDER_TRANSPARENT): out-of-source
    taps read the destination image's existing value, so a pixel whose
    window fully leaves the source keeps ``dst_base`` and a partial
    window blends source taps with it — matching cv2's remapBilinear
    (OpenCV reads whatever the caller's dst held; deterministic
    deviation: ``dst_base`` defaults to zeros)."""
    h, w = img.shape[0], img.shape[1]
    has_c = img.ndim == 3
    transparent = border == "transparent"
    base = None
    if transparent:
        border = "constant"
        base = (
            jnp.zeros(sx.shape + ((img.shape[2],) if has_c else ()),
                      img.dtype)
            if dst_base is None
            else jnp.broadcast_to(
                jnp.asarray(dst_base, img.dtype),
                sx.shape + ((img.shape[2],) if has_c else ()),
            )
        )

    if fixed_point_1024:
        xq = jnp.floor((jnp.round(sx * 1024.0) + 16.0) / 32.0)
        yq = jnp.floor((jnp.round(sy * 1024.0) + 16.0) / 32.0)
    else:
        xq = jnp.round(sx * _INTER_TAB_SIZE)
        yq = jnp.round(sy * _INTER_TAB_SIZE)
    x0 = jnp.floor(xq / _INTER_TAB_SIZE).astype(jnp.int32)
    y0 = jnp.floor(yq / _INTER_TAB_SIZE).astype(jnp.int32)
    fx = (xq - x0 * _INTER_TAB_SIZE) * (1.0 / _INTER_TAB_SIZE)
    fy = (yq - y0 * _INTER_TAB_SIZE) * (1.0 / _INTER_TAB_SIZE)
    fx = fx.astype(img.dtype) if jnp.issubdtype(img.dtype, jnp.floating) else fx
    fy = fy.astype(img.dtype) if jnp.issubdtype(img.dtype, jnp.floating) else fy

    if has_c:
        fx = fx[..., None]
        fy = fy[..., None]

    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            yi = y0 + dy
            xi = x0 + dx
            if border == "constant":
                inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                v = _gather2d(img, jnp.clip(yi, 0, h - 1), jnp.clip(xi, 0, w - 1))
                if transparent:
                    bv = base
                else:
                    bv = jnp.asarray(border_value, dtype=v.dtype)
                if has_c:
                    inside = inside[..., None]
                bv = jnp.broadcast_to(bv, v.shape)
                v = jnp.where(inside, v, bv)
            else:
                v = _gather2d(
                    img,
                    _map_border_index(yi, h, border),
                    _map_border_index(xi, w, border),
                )
            taps.append(v)
    t00, t01, t10, t11 = taps
    top = t00 * (1.0 - fx) + t01 * fx
    bot = t10 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def _dst_coords(
    m3: jnp.ndarray, dsize: Tuple[int, int], perspective: bool
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Map every dst pixel (x, y) through ``m3`` to source coords."""
    dh, dw = dsize
    ys = jnp.arange(dh, dtype=jnp.float32)[:, None]
    xs = jnp.arange(dw, dtype=jnp.float32)[None, :]
    sx = m3[0, 0] * xs + m3[0, 1] * ys + m3[0, 2]
    sy = m3[1, 0] * xs + m3[1, 1] * ys + m3[1, 2]
    if perspective:
        sw = m3[2, 0] * xs + m3[2, 1] * ys + m3[2, 2]
        inv = jnp.where(sw != 0.0, 1.0 / sw, 0.0)
        sx = sx * inv
        sy = sy * inv
    return sx, sy


def _resolve_border(
    border_mode: Union[int, str], border_value
) -> Tuple[str, Sequence[float]]:
    if isinstance(border_mode, int):
        border = constants.border_mode_name(border_mode)
    else:
        border = border_mode
    if border_value is None:
        border_value = 0.0
    return border, border_value


def warp_perspective(
    img: jnp.ndarray,
    m: jnp.ndarray,
    dsize: Optional[Tuple[int, int]] = None,
    border_mode: Union[int, str] = constants.BORDER_CONSTANT,
    border_value=None,
    inverse_map: bool = False,
    interpolation: int = constants.INTER_LINEAR,
    dst: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """OpenCV warpPerspective: dst(x,y) = src(M^-1 (x,y,1)) with
    INTER_LINEAR (ref src/lib.rs:291-299).  ``dsize`` is (h, w).
    ``dst`` is the BORDER_TRANSPARENT base image (pixels mapping outside
    the source keep its values; defaults to zeros)."""
    if dsize is None:
        dsize = (img.shape[0], img.shape[1])
    m = jnp.asarray(m, dtype=jnp.float32)
    m3 = m if not inverse_map else m
    m3 = m3 if m3.shape == (3, 3) else affine_to_3x3(m3)
    if not inverse_map:
        m3 = invert_3x3(m3)
    sx, sy = _dst_coords(m3, dsize, perspective=True)
    border, border_value = _resolve_border(border_mode, border_value)
    if interpolation == constants.INTER_NEAREST:
        return _sample_nearest(img, sx, sy, border, border_value, dst_base=dst)
    return _sample_bilinear(img, sx, sy, border, border_value, dst_base=dst)


def warp_affine(
    img: jnp.ndarray,
    m: jnp.ndarray,
    dsize: Optional[Tuple[int, int]] = None,
    border_mode: Union[int, str] = constants.BORDER_CONSTANT,
    border_value=None,
    inverse_map: bool = False,
    interpolation: int = constants.INTER_LINEAR,
    dst: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """OpenCV warpAffine with a 2x3 matrix (ref src/lib.rs:782-790).
    ``dst`` is the BORDER_TRANSPARENT base image (defaults to zeros)."""
    if dsize is None:
        dsize = (img.shape[0], img.shape[1])
    m = jnp.asarray(m, dtype=jnp.float32)
    m3 = affine_to_3x3(m) if m.shape == (2, 3) else m
    if not inverse_map:
        m3 = invert_3x3(m3)
    sx, sy = _dst_coords(m3, dsize, perspective=False)
    border, border_value = _resolve_border(border_mode, border_value)
    if interpolation == constants.INTER_NEAREST:
        return _sample_nearest(img, sx, sy, border, border_value, dst_base=dst)
    return _sample_bilinear(
        img, sx, sy, border, border_value, fixed_point_1024=True, dst_base=dst
    )


def _sample_nearest(img, sx, sy, border, border_value, dst_base=None):
    h, w = img.shape[0], img.shape[1]
    xi = jnp.round(sx).astype(jnp.int32)
    yi = jnp.round(sy).astype(jnp.int32)
    if border in ("constant", "transparent"):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = _gather2d(img, jnp.clip(yi, 0, h - 1), jnp.clip(xi, 0, w - 1))
        if border == "transparent":
            bv = (
                jnp.zeros_like(v) if dst_base is None
                else jnp.broadcast_to(jnp.asarray(dst_base, v.dtype), v.shape)
            )
        else:
            bv = jnp.broadcast_to(jnp.asarray(border_value, v.dtype), v.shape)
        if img.ndim == 3:
            inside = inside[..., None]
        return jnp.where(inside, v, bv)
    return _gather2d(
        img, _map_border_index(yi, h, border), _map_border_index(xi, w, border)
    )


def warp_valid_mask(
    m3: jnp.ndarray, src_hw: Tuple[int, int], dst_hw: Tuple[int, int],
    inverse_map: bool = True,
) -> jnp.ndarray:
    """Float mask of dst pixels whose INTER_NEAREST source tap lands inside
    the source image — equivalent to OpenCV's ECC trick of warping an
    all-ones mask with INTER_NEAREST + BORDER_CONSTANT(0)."""
    m3 = jnp.asarray(m3, dtype=jnp.float32)
    m3 = m3 if m3.shape == (3, 3) else affine_to_3x3(m3)
    if not inverse_map:
        m3 = invert_3x3(m3)
    sx, sy = _dst_coords(m3, dst_hw, perspective=True)
    h, w = src_hw
    xi = jnp.round(sx)
    yi = jnp.round(sy)
    inside = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
    return inside.astype(jnp.float32)

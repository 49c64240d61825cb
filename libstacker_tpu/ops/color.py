"""Color conversion and dtype-normalisation ops.

Device counterparts of the reference's per-frame decode helpers
(``read_grey_and_f32``, ref src/utils.rs:128-144): grayscale conversion
uses OpenCV's exact Rec.601 fixed-point arithmetic (SURVEY.md N17) and
u8->f32 normalisation multiplies by 1/255 (SURVEY.md N18).  All ops are
batched: they accept ``[..., H, W, 3]`` / ``[..., H, W]`` tensors so a
whole burst converts in one fused XLA program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# OpenCV 5.x cvtColor fixed-point luma coefficients (shift 15, verified
# exact against cv2 5.0 in tests/test_color.py):
# grey = (R2Y*R + G2Y*G + B2Y*B + 2^14) >> 15
_R2Y = 9798
_G2Y = 19235
_B2Y = 3735  # = 2^15 - R2Y - G2Y
_SHIFT = 15


@jax.jit
def rgb_to_gray_u8(rgb: jnp.ndarray) -> jnp.ndarray:
    """``[..., H, W, 3] uint8 RGB`` -> ``[..., H, W] uint8`` grayscale with
    OpenCV's fixed-point rounding (bitwise-identical to cvtColor
    COLOR_BGR2GRAY on the equivalent BGR image; ref src/utils.rs:136-142).
    uint16 inputs reduce to their high byte first (alignment and
    sharpness run on the 8-bit domain regardless of burst depth)."""
    rgb = depth_reduce_u8(rgb)
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)
    acc = _R2Y * r + _G2Y * g + _B2Y * b + (1 << (_SHIFT - 1))
    return (acc >> _SHIFT).astype(jnp.uint8)


def rgb_to_gray_f32(rgb: jnp.ndarray) -> jnp.ndarray:
    """Float Rec.601 luma for float inputs (no fixed-point rounding)."""
    scale = 1.0 / (1 << _SHIFT)
    return (
        rgb[..., 0] * (_R2Y * scale)
        + rgb[..., 1] * (_G2Y * scale)
        + rgb[..., 2] * (_B2Y * scale)
    ).astype(jnp.float32)


def u8_to_f32(img: jnp.ndarray) -> jnp.ndarray:
    """uint8 -> float32 in [0, 1] (convert_to CV_32F alpha=1/255,
    ref src/utils.rs:133)."""
    return img.astype(jnp.float32) * (1.0 / 255.0)


def depth_reduce_u8(img: jnp.ndarray) -> jnp.ndarray:
    """uint16 -> high-byte uint8 (the exact 16->8 range reduction, the
    inverse of the x257 expansion); uint8 passes through.  The
    alignment stages (FAST thresholds, ECC greys, phase correlation)
    run on the 8-bit domain regardless of input depth — registration
    accuracy is sub-pixel-geometry limited, not quantisation limited —
    so a uint16 burst solves BIT-IDENTICAL warps to its high-byte
    uint8 reduction while stacking keeps the full depth
    (:func:`to_unit_f32`)."""
    if img.dtype == jnp.uint16:
        return (img >> 8).astype(jnp.uint8)
    return img


def to_unit_f32(img: jnp.ndarray) -> jnp.ndarray:
    """Frames -> float32 in [0, 1] at native depth: uint8 * 1/255,
    uint16 * 1/65535 (16-bit bursts stack at full precision — beyond
    the reference, whose OpenCV stages assert 8-bit input); float
    passes through."""
    if img.dtype == jnp.uint16:
        return img.astype(jnp.float32) * (1.0 / 65535.0)
    if jnp.issubdtype(img.dtype, jnp.floating):
        return img.astype(jnp.float32)
    return u8_to_f32(img)

"""Batched frame warping.

Warps an [N,H,W,C] burst with per-frame matrices (forward OpenCV
semantics: the matrix is inverted internally like warpPerspective,
ref src/lib.rs:291-299) on XLA's gather path, with every border mode
the reference feeds into OpenCV's C++ warp (src/lib.rs:66-72).
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp

from . import color, warp


def warp_frames_batch(
    frames: jnp.ndarray,  # [N,H,W,C] or [N,H,W] float32
    mats: jnp.ndarray,  # [N,3,3] (or [N,2,3] affine), forward maps
    perspective: bool = True,
    border_value=0.0,
    border_mode: Union[int, str] = "constant",
) -> jnp.ndarray:
    """Warp each frame onto its own grid with the given border mode."""
    h, w = frames.shape[1], frames.shape[2]
    border, border_value = warp._resolve_border(border_mode, border_value)
    m3 = mats if mats.shape[-2] == 3 else jax.vmap(warp.affine_to_3x3)(mats)

    def warp_one(frame, m):
        if perspective:
            return warp.warp_perspective(
                frame, m, (h, w), border_mode=border,
                border_value=border_value,
            )
        return warp.warp_affine(
            frame, m[:2], (h, w), border_mode=border,
            border_value=border_value,
        )

    return jax.vmap(warp_one)(frames, m3)


def warp_accumulate_rgb(
    frames: jnp.ndarray,  # [N,H,W,3] float32 OR uint8/uint16 (raw burst)
    mats: jnp.ndarray,  # [N,3,3] (or [N,2,3]) FORWARD maps
    oks: jnp.ndarray,  # [N] bool — dropped lanes contribute 0
    perspective: bool = True,
    border_value=0.0,
) -> jnp.ndarray:
    """Stage-3 fusion: ``sum_n oks[n] * warp(frames[n])`` -> [H,W,3]
    (BORDER_CONSTANT).  One scan step per frame: the raw integer frame
    is widened (``color.to_unit_f32``), warped and added to the running
    sum, so no [N,H,W,3] f32 intermediate exists and each frame is read
    once."""
    m3 = mats if mats.shape[-2] == 3 else jax.vmap(warp.affine_to_3x3)(mats)
    # NaN/garbage matrices of dropped lanes must not reach the warp
    m3 = jnp.where(oks[:, None, None], m3, jnp.eye(3, dtype=m3.dtype))

    def body(acc, xs):
        frame, m, ok = xs
        f = color.to_unit_f32(frame)
        out = warp_frames_batch(
            f[None], m[None], perspective=perspective,
            border_value=border_value,
        )[0]
        return acc + jnp.where(ok, out, 0.0), None

    acc0 = jnp.zeros(frames.shape[1:], jnp.float32)
    acc, _ = jax.lax.scan(body, acc0, (frames, m3, oks))
    return acc

"""Fused ECC Gauss-Newton iteration kernel (Pallas, Triton route).

The plain XLA iteration (ops/ecc.py ``_ecc_loop_batched`` without the
kernel) writes and re-reads about twelve image-sized f32 fields per
lane per iteration (three warped planes, a validity mask and up to
eight Jacobian fields) and then reduces them with a batched einsum.
This kernel does the whole iteration in one pass: each program takes
one lane and a run of ``PIXELS_PER_PROGRAM`` output pixels and

- inverse-maps its pixels through the lane's warp with OpenCV's
  1/32-px coordinate quantisation (the same rule as ops/warp.py, so
  both paths sample the same taps),
- gathers the four bilinear taps of the image and its two gradients
  straight from the source planes in device memory (BORDER_CONSTANT 0),
  plus, for a masked solve, the INTER_NEAREST tap of the preprocessed
  inputMask plane,
- builds the motion model's Jacobian in registers and reduces the
  iteration's raw sums:

    [ n, S(m*i), S(m*i^2), S(m*t), S(m*t^2), S(m*t*i),
      S(jac_p*i) (P), S(jac_p*m) (P), S(jac_p*m*t) (P)
      [, H_pq upper triangle (P(P+1)/2) when with_hessian] ]

and writes one partial-sum row per program (``[B, n_programs,
n_pad]``); XLA adds the rows.  A lane marked inactive (converged or
failed) writes zeros and returns at once.  Only the source planes and
the template are read; nothing image-sized is written.

ops/ecc.py rebuilds OpenCV's quantities from these sums
(:func:`unpack_moments`):

    correlation   = S(mti) - iMean*S(mt) - tMean*S(mi) + tMean*iMean*n
    image_proj_p  = S(jac_p * i) - iMean * S(jac_p * m)
    template_proj = S(jac_p*m*t) - tMean * S(jac_p * m)

:func:`ecc_moments_reference` computes the same vector from the XLA
fields path and is the kernel's test oracle.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import constants
from ..params import MotionType
from . import warp

# pixels per inner step (one Triton block) and inner steps per program
BLOCK = 256
STEPS = 64
PIXELS_PER_PROGRAM = BLOCK * STEPS
NUM_WARPS = 4


def moments_layout(
    motion_type: MotionType, with_hessian: bool = True
) -> Tuple[int, int]:
    """(n_params, n_out) of the moments vector of a motion model.
    ``with_hessian=False`` drops the Jacobian-Gram upper triangle (the
    lazy solver carries the Gram instead of recomputing it)."""
    p = motion_type.num_params
    n = 6 + 3 * p
    if with_hessian:
        n += p * (p + 1) // 2
    return p, n


def _round_half_even(v):
    """``jnp.round`` (half to even) from floor and compares, which the
    Triton lowering has."""
    f = jnp.floor(v)
    d = v - f
    odd = f - 2.0 * jnp.floor(f * 0.5)
    up = jnp.where(d > 0.5, 1.0, jnp.where(d == 0.5, odd, 0.0))
    return f + up


def _quantise(s, quant_affine: bool):
    """Source coordinate -> (tap-0 integer coordinate as f32, weight of
    tap 1), ops/warp.py ``_sample_bilinear``'s rule: warpAffine's
    1/1024 fixed point then 1/32 bins, warpPerspective's direct 1/32
    rounding."""
    if quant_affine:
        q = jnp.floor((_round_half_even(s * 1024.0) + 16.0) / 32.0)
    else:
        q = _round_half_even(s * 32.0)
    i0 = jnp.floor(q / 32.0)
    return i0, (q - i0 * 32.0) * (1.0 / 32.0)


def _jacobian(motion_type, gxw, gyw, xs, ys, sx, sy, inv_den, m):
    """Per-pixel Jacobian fields matching ops/ecc.py
    ``_jacobian_fields_batched`` (``sx``/``sy`` are OpenCV's
    hatX/hatY)."""
    if motion_type == MotionType.Translation:
        return [gxw, gyw]
    if motion_type == MotionType.Euclidean:
        h0, h1 = m[0], m[3]
        hat_x = -xs * h1 - ys * h0
        hat_y = xs * h0 - ys * h1
        return [gxw * hat_x + gyw * hat_y, gxw, gyw]
    if motion_type == MotionType.Affine:
        return [gxw * xs, gyw * xs, gxw * ys, gyw * ys, gxw, gyw]
    gxd = gxw * inv_den
    gyd = gyw * inv_den
    tmp = sx * gxd + sy * gyd
    return [gxd * xs, gyd * xs, -tmp * xs, gxd * ys, gyd * ys, -tmp * ys,
            gxd, gyd]


def _moments_kernel(
    prm_ref,  # [16]: 9 matrix entries, active flag, padding
    src_ref,  # [n_src * H * W] source planes, flattened
    tmpl_ref,  # [H * W] this lane's template, flattened
    out_ref,  # [n_pad] this program's partial sums
    *,
    h: int,
    w: int,
    n_src: int,
    motion_type: MotionType,
    quant_affine: bool,
    with_hessian: bool,
    n_out: int,
    n_pad: int,
):
    prog = pl.program_id(1)
    hw = h * w
    active = prm_ref[9] != 0.0

    @pl.when(jnp.logical_not(active))
    def _():
        out_ref[...] = jnp.zeros((n_pad,), jnp.float32)

    @pl.when(active)
    def _():
        m = [prm_ref[i] for i in range(9)]
        lane = jnp.arange(BLOCK, dtype=jnp.int32)
        p = motion_type.num_params

        def step(s, acc):
            idx = prog * PIXELS_PER_PROGRAM + s * BLOCK + lane
            valid = idx < hw
            idx = jnp.minimum(idx, hw - 1)
            yi_out = jax.lax.div(idx, jnp.int32(w))
            xs = (idx - yi_out * w).astype(jnp.float32)
            ys = yi_out.astype(jnp.float32)
            den = m[6] * xs + m[7] * ys + m[8]
            inv = jnp.where(den != 0.0, 1.0 / den, 0.0)
            sx = (m[0] * xs + m[1] * ys + m[2]) * inv
            sy = (m[3] * xs + m[4] * ys + m[5]) * inv
            x0, fx = _quantise(sx, quant_affine)
            y0, fy = _quantise(sy, quant_affine)
            x0i = x0.astype(jnp.int32)
            y0i = y0.astype(jnp.int32)

            def tap_offsets(dy, dx):
                yy = y0i + dy
                xx = x0i + dx
                inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                off = (jnp.clip(yy, 0, h - 1) * w + jnp.clip(xx, 0, w - 1))
                return off, inside

            taps = [tap_offsets(dy, dx) for dy in (0, 1) for dx in (0, 1)]

            def sample(c):
                vals = [
                    jnp.where(ins, src_ref[off + c * hw], 0.0)
                    for off, ins in taps
                ]
                top = vals[0] * (1.0 - fx) + vals[1] * fx
                bot = vals[2] * (1.0 - fx) + vals[3] * fx
                return top * (1.0 - fy) + bot * fy

            vf = valid.astype(jnp.float32)
            imw = sample(0) * vf
            gxw = sample(1) * vf
            gyw = sample(2) * vf
            # INTER_NEAREST validity: round the unquantised coordinate
            xn = _round_half_even(sx)
            yn = _round_half_even(sy)
            inside_n = (
                (xn >= 0.0) & (xn <= w - 1.0) & (yn >= 0.0) & (yn <= h - 1.0)
            )
            if n_src == 4:
                off_n = (
                    jnp.clip(yn.astype(jnp.int32), 0, h - 1) * w
                    + jnp.clip(xn.astype(jnp.int32), 0, w - 1)
                )
                mask = jnp.where(
                    inside_n & valid, src_ref[off_n + 3 * hw], 0.0
                )
            else:
                mask = (inside_n & valid).astype(jnp.float32)
            tmpl = jnp.where(valid, tmpl_ref[idx], 0.0)
            jac = _jacobian(motion_type, gxw, gyw, xs, ys, sx, sy, inv, m)
            mi = mask * imw
            mt = mask * tmpl
            terms = [mask, mi, mi * imw, mt, mt * tmpl, mt * imw]
            terms += [j * imw for j in jac]
            terms += [j * mask for j in jac]
            terms += [j * mt for j in jac]
            if with_hessian:
                terms += [jac[a] * jac[b] for a in range(p)
                          for b in range(a, p)]
            return tuple(a + t for a, t in zip(acc, terms))

        zero = jnp.zeros((BLOCK,), jnp.float32)
        acc = jax.lax.fori_loop(0, STEPS, step, (zero,) * n_out)
        pos = jnp.arange(n_pad, dtype=jnp.int32)
        row = jnp.zeros((n_pad,), jnp.float32)
        for i, a in enumerate(acc):
            row = jnp.where(pos == i, jnp.sum(a), row)
        out_ref[...] = row


@functools.partial(
    jax.jit,
    static_argnames=("motion_type", "quant_affine", "with_hessian",
                     "interpret"),
)
def ecc_iteration_moments(
    srcs: jnp.ndarray,  # [3|4, H, W] f32 (image, gx, gy[, pre-mask])
    templates: jnp.ndarray,  # [B, H, W] f32
    m3: jnp.ndarray,  # [B, 3, 3] warps (inverse-map convention)
    active: jnp.ndarray,  # [B] bool: inactive lanes return zero rows
    motion_type: MotionType,
    quant_affine: bool = False,
    with_hessian: bool = True,
    interpret: bool = False,
) -> jnp.ndarray:
    """One fused ECC iteration -> [B, n_out] raw moments.

    A 4th ``srcs`` plane is cv2 findTransformECC's preprocessed binary
    inputMask (ops/ecc.py ``_ecc_prepare_input_masked_jit``; the
    gradients must already be multiplied by it); its nearest tap takes
    the place of the all-ones validity mask.  ``interpret`` runs the
    kernel in the Pallas interpreter (CPU tests)."""
    n_src, h, w = srcs.shape
    if n_src not in (3, 4):
        raise ValueError(f"srcs must hold 3 or 4 planes, got {srcs.shape}")
    b = templates.shape[0]
    if tuple(templates.shape[1:]) != (h, w):
        raise ValueError(
            f"templates {templates.shape[1:]} != source extent {(h, w)}"
        )
    _, n_out = moments_layout(motion_type, with_hessian)
    n_pad = 1 << (n_out - 1).bit_length()
    hw = h * w
    n_prog = pl.cdiv(hw, PIXELS_PER_PROGRAM)
    params = jnp.concatenate(
        [
            m3.reshape(b, 9).astype(jnp.float32),
            active.astype(jnp.float32)[:, None],
            jnp.zeros((b, 6), jnp.float32),
        ],
        axis=1,
    )
    kernel = functools.partial(
        _moments_kernel, h=h, w=w, n_src=n_src, motion_type=motion_type,
        quant_affine=quant_affine, with_hessian=with_hessian, n_out=n_out,
        n_pad=n_pad,
    )
    parts = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((b, n_prog, n_pad), jnp.float32),
        grid=(b, n_prog),
        in_specs=[
            pl.BlockSpec((None, 16), lambda i, j: (i, 0)),
            pl.BlockSpec((n_src * hw,), lambda i, j: (0,)),
            pl.BlockSpec((None, hw), lambda i, j: (i, 0)),
        ],
        out_specs=pl.BlockSpec((None, None, n_pad), lambda i, j: (i, j, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="ecc_iteration_moments",
    )(
        params,
        srcs.astype(jnp.float32).reshape(-1),
        templates.astype(jnp.float32).reshape(b, hw),
    )
    return jnp.sum(parts, axis=1)[:, :n_out]


def unpack_moments(
    mom: jnp.ndarray, motion_type: MotionType, with_hessian: bool = True
):
    """[B, n_out] moments -> (n_raw, s_mi, s_mii, s_mt, s_mtt, s_mti,
    hessian [B,P,P] (or None), j_i [B,P], j_m [B,P], j_mt [B,P])."""
    p = motion_type.num_params
    n_raw = mom[:, 0]
    s_mi, s_mii, s_mt, s_mtt, s_mti = (mom[:, i] for i in range(1, 6))
    j_i = mom[:, 6 : 6 + p]
    j_m = mom[:, 6 + p : 6 + 2 * p]
    j_mt = mom[:, 6 + 2 * p : 6 + 3 * p]
    hess = None
    if with_hessian:
        o = 6 + 3 * p
        tri = mom[:, o : o + p * (p + 1) // 2]
        rows, cols = jnp.triu_indices(p)
        hess = jnp.zeros((mom.shape[0], p, p), mom.dtype)
        hess = hess.at[:, rows, cols].set(tri)
        hess = hess.at[:, cols, rows].set(tri)
    return n_raw, s_mi, s_mii, s_mt, s_mtt, s_mti, hess, j_i, j_m, j_mt


@functools.partial(
    jax.jit, static_argnames=("motion_type", "with_hessian")
)
def ecc_moments_reference(
    srcs: jnp.ndarray,
    templates: jnp.ndarray,
    m3: jnp.ndarray,
    motion_type: MotionType,
    with_hessian: bool = True,
) -> jnp.ndarray:
    """The moments vector of :func:`ecc_iteration_moments` computed from
    the plain XLA fields (ops/warp.py warps, the ECC Jacobian fields of
    ops/ecc.py) — the kernel's oracle."""
    from .ecc import _jacobian_fields_batched

    n_src, h, w = srcs.shape
    perspective = motion_type == MotionType.Homography

    def warp_lane(mm):
        def lin(s):
            if perspective:
                return warp.warp_perspective(
                    s, mm, (h, w), border_mode="constant", border_value=0.0,
                    inverse_map=True,
                )
            return warp.warp_affine(
                s, mm[:2], (h, w), border_mode="constant", border_value=0.0,
                inverse_map=True,
            )

        fields = jax.vmap(lin)(srcs[:3])
        if n_src == 4:
            if perspective:
                mask = warp.warp_perspective(
                    srcs[3], mm, (h, w), border_mode="constant",
                    border_value=0.0, inverse_map=True,
                    interpolation=constants.INTER_NEAREST,
                )
            else:
                mask = warp.warp_affine(
                    srcs[3], mm[:2], (h, w), border_mode="constant",
                    border_value=0.0, inverse_map=True,
                    interpolation=constants.INTER_NEAREST,
                )
        else:
            mask = warp.warp_valid_mask(mm, (h, w), (h, w), inverse_map=True)
        return fields, mask

    fields, mask = jax.vmap(warp_lane)(m3)
    imw, gxw, gyw = fields[:, 0], fields[:, 1], fields[:, 2]
    xg = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
    yg = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
    jac = _jacobian_fields_batched(motion_type, gxw, gyw, xg, yg, m3)
    t = templates
    ax = (1, 2)
    cols = [
        jnp.sum(mask, ax), jnp.sum(mask * imw, ax),
        jnp.sum(mask * imw * imw, ax), jnp.sum(mask * t, ax),
        jnp.sum(mask * t * t, ax), jnp.sum(mask * t * imw, ax),
    ]
    p = motion_type.num_params
    cols += [jnp.sum(jac[:, a] * imw, ax) for a in range(p)]
    cols += [jnp.sum(jac[:, a] * mask, ax) for a in range(p)]
    cols += [jnp.sum(jac[:, a] * mask * t, ax) for a in range(p)]
    if with_hessian:
        cols += [jnp.sum(jac[:, a] * jac[:, b], ax)
                 for a in range(p) for b in range(a, p)]
    return jnp.stack(cols, axis=1)


def moments_error(got, want, motion_type: MotionType):
    """How far a moments vector ``got`` is from ``want`` ([B, n_out]
    with the Hessian triangle): (largest relative error of the six
    statistics sums, largest error of the other sums over their
    Cauchy-Schwarz scale, e.g. sqrt(S(jac_p^2) S(m i^2)) for
    S(jac_p i)).  The Jacobian sums cancel heavily, so their error is
    judged against the size of their terms, not of their value."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    p, n_out = moments_layout(motion_type, True)
    if want.shape[-1] != n_out or got.shape != want.shape:
        raise ValueError(f"need two [B, {n_out}] vectors with the Hessian")
    tiny = 1e-30
    stats = np.abs(got[:, :6] - want[:, :6]) / np.maximum(
        np.abs(want[:, :6]), tiny
    )
    rows, cols = np.triu_indices(p)
    tri = want[:, 6 + 3 * p:]
    diag = np.maximum(tri[:, rows == cols], 0.0)  # S(jac_p^2)
    n, s_mii, s_mtt = want[:, 0:1], want[:, 2:3], want[:, 4:5]
    scale = np.concatenate(
        [np.sqrt(diag * s_mii), np.sqrt(diag * n), np.sqrt(diag * s_mtt),
         np.sqrt(diag[:, rows] * diag[:, cols])],
        axis=1,
    )
    other = np.abs(got[:, 6:] - want[:, 6:]) / np.maximum(scale, tiny)
    return float(stats.max()), float(other.max())

"""Batched Enhanced Correlation Coefficient (ECC) alignment engine.

Re-implementation of OpenCV's ``findTransformECC`` (Evangelidis &
Psarakis, PAMI 2008) — the reference's dominant hot loop (SURVEY.md
N9; call sites ref src/lib.rs:769-777, 931-939).  Where the reference
runs one iterative C++ solver per Rayon thread, this engine is **one
batched device program per lane group**: an explicitly batched
Gauss-Newton iteration inside a ``lax.while_loop`` of unrolled
``lax.scan`` chunks with per-frame convergence masking, optionally
preceded by coarse-to-fine octaves.  On a GPU each iteration is one
fused Triton kernel (ops/ecc_triton.py); elsewhere, and as the
reference, it runs on XLA's gather path.

Faithfulness to OpenCV ecc.cpp:
- Gaussian pre-filter of template and input with ``gauss_filt_size``
  (sigma 0 -> OpenCV's fixed small kernels / derived sigma).
- Input-image gradients with the [-0.5, 0, 0.5] central-difference
  filter (reflect-101 border).
- Per iteration: inverse-map warps of image and gradients onto the
  template grid, an INTER_NEAREST-warped validity mask, masked
  zero-mean statistics, the motion-specific Jacobian, Gauss-Newton
  style update via the 8x8 (or smaller) projected Hessian, and the
  ``|rho - last_rho| < eps`` termination test evaluated at loop top.
- Failure cases (NaN rho, lambda_d <= 0) are reported per frame via an
  ``ok`` flag instead of aborting the batch (flagged deviation: the
  reference aborts the whole stack, SURVEY.md §5).

Motion models: Translation (2 dof), Euclidean (3), Affine (6),
Homography (8) — parameter ordering and update rules match OpenCV's
``update_warping_matrix_ECC`` exactly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .. import constants
from ..params import MotionType
from . import filters, warp

_HIGHEST = jax.lax.Precision.HIGHEST

# Iterations per while_loop chunk: early exit happens at chunk
# granularity (<= _CHUNK_ITERS - 1 wasted masked iterations; typical
# eps-converged solves take 4-8 iterations, so keep chunks small).
_CHUNK_ITERS = 4


def _lanes_per_group(h: int, w: int, kernel: bool) -> int:
    """Lanes solved as one batched program at an (h, w) grid, from the
    device's memory.  The XLA path keeps about 16 image-sized f32
    fields per lane live (3 warped planes, the mask, up to 8 Jacobian
    fields and their products); the kernel keeps the template and a
    few partial sums.  Half of ``bytes_limit`` is left to the burst and
    the other programs."""
    from ..utils.device import device_bytes_limit

    per_lane = (16 if not kernel else 2) * h * w * 4
    return max(1, device_bytes_limit() // 2 // max(per_lane, 1))


class EccResult(NamedTuple):
    rho: jnp.ndarray  # correlation coefficient, [] or [N]
    warp_matrix: jnp.ndarray  # [2,3] or [3,3] (batched: leading N)
    ok: jnp.ndarray  # bool, False if the solver hit an OpenCV error case
    num_iters: jnp.ndarray  # iterations actually executed


def identity_warp(motion_type: MotionType, dtype=jnp.float32) -> jnp.ndarray:
    """Initial warp: eye(2,3) for non-homography, eye(3,3) for homography
    (ref src/lib.rs:763-767)."""
    if motion_type == MotionType.Homography:
        return jnp.eye(3, dtype=dtype)
    return jnp.eye(2, 3, dtype=dtype)


def _as_3x3(m: jnp.ndarray) -> jnp.ndarray:
    return m if m.shape[-2] == 3 else warp.affine_to_3x3(m)


def _update_warp(
    motion_type: MotionType, m: jnp.ndarray, dp: jnp.ndarray
) -> jnp.ndarray:
    """OpenCV update_warping_matrix_ECC parameter ordering."""
    if motion_type == MotionType.Translation:
        return m.at[0, 2].add(dp[0]).at[1, 2].add(dp[1])
    if motion_type == MotionType.Euclidean:
        new_theta = dp[0] + jnp.arcsin(jnp.clip(m[1, 0], -1.0, 1.0))
        c, s = jnp.cos(new_theta), jnp.sin(new_theta)
        return jnp.array(
            [[c, -s, m[0, 2] + dp[1]], [s, c, m[1, 2] + dp[2]]], dtype=m.dtype
        )
    if motion_type == MotionType.Affine:
        upd = jnp.array(
            [[dp[0], dp[2], dp[4]], [dp[1], dp[3], dp[5]]], dtype=m.dtype
        )
        return m + upd
    upd = jnp.array(
        [
            [dp[0], dp[3], dp[6]],
            [dp[1], dp[4], dp[7]],
            [dp[2], dp[5], 0.0],
        ],
        dtype=m.dtype,
    )
    return m + upd


_ECC_MODES = ("forward", "lazy")


def _check_mode(mode: str) -> str:
    from ..errors import InvalidParamsError

    if mode not in _ECC_MODES:
        raise InvalidParamsError(
            f"ECC solver mode must be one of {_ECC_MODES}, got {mode!r}"
            + (" (the inverse-compositional solver was removed)"
               if mode == "ic" else "")
        )
    return mode


def _ecc_mode_default() -> str:
    """Solver formulation: 'forward' (OpenCV's forward-additive ECC,
    bit-faithful) or 'lazy' (forward linearisation with the Jacobian
    Gram computed once per lane and carried: 30 instead of 66 kernel
    reductions per homography iteration, same fixed point; only the
    fused kernel implements it).  Overridable via LIBSTACKER_ECC_MODE."""
    import os

    v = os.environ.get("LIBSTACKER_ECC_MODE", "").strip().lower()
    return _check_mode(v) if v else "forward"


def find_transform_ecc(
    template: jnp.ndarray,
    input_image: jnp.ndarray,
    motion_type: MotionType = MotionType.Affine,
    num_iters: int = 200,
    eps: float = -1.0,
    gauss_filt_size: int = 5,
    warp_init: Optional[jnp.ndarray] = None,
    mode: Optional[str] = None,
    input_mask: Optional[jnp.ndarray] = None,
) -> EccResult:
    """Estimate the warp aligning ``input_image`` to ``template``.

    Semantics match ``cv2.findTransformECC(template, input, warp, motion,
    criteria, input_mask, gauss_filt_size)``: the returned matrix ``M`` warps
    ``input_image`` onto the template grid via dst(x,y) = input(M(x,y))
    (i.e. the WARP_INVERSE_MAP convention used internally; the caller
    then applies plain ``warp_affine``/``warp_perspective`` exactly like
    the reference does at src/lib.rs:780-803).

    ``template`` / ``input_image``: [H,W] uint8 or float (raw 0..255
    scale, like OpenCV's internal convertTo(CV_32F) without rescaling).

    Runs through the batched host driver
    (:func:`find_transform_ecc_batched`).  For a fully in-graph
    (traceable) solve use :func:`find_transform_ecc_batched_graph`.
    """
    res = find_transform_ecc_batched(
        jnp.asarray(template)[None],
        input_image,
        motion_type=motion_type,
        num_iters=num_iters,
        eps=eps,
        gauss_filt_size=gauss_filt_size,
        warp_init=(
            None if warp_init is None
            else jnp.asarray(warp_init, jnp.float32)[None]
        ),
        mode=mode,
        input_mask=input_mask,
    )
    return EccResult(
        rho=res.rho[0],
        warp_matrix=res.warp_matrix[0],
        ok=res.ok[0],
        num_iters=res.num_iters[0],
    )


def _input_fields(input_image, gauss_filt_size):
    """Input-side fields: Gaussian pre-filter + central-difference
    gradients (OpenCV ecc.cpp's image preparation)."""
    image_f = filters.gaussian_blur(
        input_image.astype(jnp.float32), gauss_filt_size
    )
    dx = (-0.5, 0.0, 0.5)
    gx = filters.sep_filter2d(image_f, dx, (1.0,), border="reflect101")
    gy = filters.sep_filter2d(image_f, (1.0,), dx, border="reflect101")
    return image_f, gx, gy


def _prepare_inputs(templates, input_image, gauss_filt_size):
    image_f, gx, gy = _input_fields(input_image, gauss_filt_size)
    templates_f = filters.gaussian_blur(
        templates.astype(jnp.float32), gauss_filt_size
    )
    return templates_f, image_f, gx, gy


@functools.partial(jax.jit, static_argnames=("gauss_filt_size",))
def _ecc_prepare_input_masked_jit(input_image, input_mask, gauss_filt_size):
    """Input-side fields plus OpenCV's inputMask preprocessing
    (ecc.cpp): threshold the mask to 0/1, Gaussian-blur it with the
    same ``gauss_filt_size``, re-threshold at 0.95 via the
    ``* 0.5/0.95`` + rounding-convert trick (an erosion by the blur
    support, so no partially-masked pixel survives), and pre-multiply
    the input gradients by the resulting binary mask — exactly what
    ``gradientX.mul(preMaskFloat)`` does before the iteration loop."""
    image_f, gx, gy = _input_fields(input_image, gauss_filt_size)
    pre = (input_mask > 0).astype(jnp.float32)
    pre_f = filters.gaussian_blur(pre, gauss_filt_size)
    # cvRound is round-half-even, same as jnp.round
    pre_bin = jnp.round(pre_f * (0.5 / 0.95))
    return image_f, gx * pre_bin, gy * pre_bin, pre_bin


def find_transform_ecc_batched_graph(
    templates: jnp.ndarray,
    input_image: jnp.ndarray,
    motion_type: MotionType = MotionType.Affine,
    num_iters: int = 200,
    eps: float = -1.0,
    gauss_filt_size: int = 5,
    warp_init: Optional[jnp.ndarray] = None,
    mode: Optional[str] = None,
    input_mask: Optional[jnp.ndarray] = None,
    coarse_levels: int = 0,
) -> EccResult:
    """In-graph batched ECC (traceable inside jit / shard_map): one warp
    per template frame against a shared input image, solved by one
    ``while_loop`` (the fused kernel on a GPU, see
    :func:`_kernel_ok`).  Prefer :func:`find_transform_ecc_batched` at
    the host level — it sizes lane groups to the device's memory.

    ``input_mask`` ([H,W], nonzero = valid): cv2's ``inputMask``
    semantics, identical to the host driver's (the mask is binarised,
    blurred, re-thresholded and pre-multiplied into the input
    gradients; every iteration nearest-warps it) — traced in-graph so
    masked solves work under shard_map.

    ``coarse_levels`` > 0 runs the in-graph coarse-to-fine cascade:
    octaves are built by cascaded 2x INTER_AREA reductions (matmul
    resizes — shard_map safe) and each level's solve warm-starts the
    next; the full-resolution solve owns the exact criteria.  No
    cross-scale rho seeding (the fine solve always confirms
    convergence on its own content).

    ``mode``: 'forward' or 'lazy' (see :func:`_ecc_mode_default`); the
    XLA path always runs 'forward'."""
    mode = _check_mode(_ecc_mode_default() if mode is None else mode)
    if coarse_levels > 0:
        n0, h0, w0 = templates.shape
        levels = [
            lvl for lvl in range(1, coarse_levels + 1)
            if min(h0, w0) // 2 ** lvl >= 64
        ]
        octaves = {}
        tl, il = templates, input_image
        ml = (
            None if input_mask is None
            else (jnp.asarray(input_mask) > 0).astype(jnp.float32)
        )
        from . import resize as _resize
        from .. import constants as _constants

        for lvl in range(1, (max(levels) + 1) if levels else 1):
            s = 2 ** lvl
            dh, dw = h0 // s, w0 // s
            tl = _resize.resize(tl, (dh, dw), _constants.INTER_AREA)
            il = _resize.resize(il, (dh, dw), _constants.INTER_AREA)
            if ml is not None:
                ml = _resize.resize(ml, (dh, dw), _constants.INTER_AREA)
            if lvl in levels:
                # conservative mask downscale (same rule as the host
                # driver): a coarse pixel stays valid only if >= half
                # its INTER_AREA footprint was
                octaves[lvl] = (tl, il, None if ml is None else ml >= 0.5)
        init = warp_init
        init_at_full_scale = warp_init is not None
        for lvl in sorted(octaves, reverse=True):
            s = 2 ** lvl
            tl, il, mlv = octaves[lvl]
            if init_at_full_scale:
                init = _rescale_warp_batch(init, motion_type, 1.0 / s)
                init_at_full_scale = False
            res = find_transform_ecc_batched_graph(
                tl, il, motion_type, num_iters, eps, gauss_filt_size,
                warp_init=init, mode=mode, input_mask=mlv,
                coarse_levels=0,
            )
            # a failed/frozen octave lane's iterate is not a meaningful
            # warm start — hand the finer level this level's own init
            base = (
                jnp.tile(identity_warp(motion_type)[None], (n0, 1, 1))
                if init is None else init
            )
            wm = jnp.where(res.ok[:, None, None], res.warp_matrix, base)
            init = _rescale_warp_batch(wm, motion_type, 2.0)
        return find_transform_ecc_batched_graph(
            templates, input_image, motion_type, num_iters, eps,
            gauss_filt_size, warp_init=init, mode=mode,
            input_mask=input_mask, coarse_levels=0,
        )
    pre_mask = None
    if input_mask is not None:
        image_f, gx, gy, pre_mask = _ecc_prepare_input_masked_jit(
            input_image, input_mask, gauss_filt_size
        )
        templates_f = filters.gaussian_blur(
            templates.astype(jnp.float32), gauss_filt_size
        )
    else:
        templates_f, image_f, gx, gy = _prepare_inputs(
            templates, input_image, gauss_filt_size
        )
    n, h, w = templates_f.shape
    warp0 = identity_warp(motion_type)
    # tie the carry init to the input data so the carry has the same
    # varying-manual-axes type as the body output under shard_map
    vzero = templates_f[0, 0, 0] * 0.0
    m_init = (
        jnp.tile(warp0[None], (n, 1, 1)) if warp_init is None
        else jnp.asarray(warp_init, jnp.float32)
    )
    carry = (
        m_init + vzero,
        jnp.full((n,), -1.0, jnp.float32) + vzero,
        jnp.full((n,), -float(eps), jnp.float32) + vzero,
        jnp.zeros((n,), jnp.int32),
        jnp.ones((n,), bool) & (vzero == 0.0),
    )
    kernel = _kernel_ok(h, w) and tuple(image_f.shape) == (h, w)
    if kernel and mode == "lazy":
        p = motion_type.num_params
        carry = carry + (
            jnp.zeros((n, p, p), jnp.float32) + vzero,  # carried Gram
            jnp.zeros((n,), bool) | (vzero != 0.0),  # h_ok
        )
    final = _ecc_loop_batched(
        templates_f, image_f, gx, gy, carry, motion_type, num_iters, eps,
        None, kernel, mode, pre_mask,
    )
    m, rho, _, it, ok = final[:5]
    return EccResult(rho=rho, warp_matrix=m, ok=ok, num_iters=it)


def _jacobian_fields_batched(
    motion_type: MotionType,
    gxw: jnp.ndarray,  # [B,H,W]
    gyw: jnp.ndarray,
    xg: jnp.ndarray,  # [H,W]
    yg: jnp.ndarray,
    m3: jnp.ndarray,  # [B,3,3]
) -> jnp.ndarray:
    """Batched variant of :func:`_jacobian_fields` -> [B,P,H,W]."""
    xb = xg[None]
    yb = yg[None]
    if motion_type == MotionType.Translation:
        return jnp.stack([gxw, gyw], axis=1)
    if motion_type == MotionType.Euclidean:
        h0 = m3[:, 0, 0][:, None, None]
        h1 = m3[:, 1, 0][:, None, None]
        hat_x = -xb * h1 - yb * h0
        hat_y = xb * h0 - yb * h1
        return jnp.stack([gxw * hat_x + gyw * hat_y, gxw, gyw], axis=1)
    if motion_type == MotionType.Affine:
        return jnp.stack(
            [gxw * xb, gyw * xb, gxw * yb, gyw * yb, gxw, gyw], axis=1
        )
    c = lambda i, j: m3[:, i, j][:, None, None]
    den = xb * c(2, 0) + yb * c(2, 1) + 1.0
    inv_den = 1.0 / den
    hat_x = (xb * c(0, 0) + yb * c(0, 1) + c(0, 2)) * inv_den
    hat_y = (xb * c(1, 0) + yb * c(1, 1) + c(1, 2)) * inv_den
    gxd = gxw * inv_den
    gyd = gyw * inv_den
    tmp = hat_x * gxd + hat_y * gyd
    return jnp.stack(
        [gxd * xb, gyd * xb, -tmp * xb, gxd * yb, gyd * yb, -tmp * yb,
         gxd, gyd],
        axis=1,
    )


def _ecc_loop_batched(
    templates_f: jnp.ndarray,  # [B,H,W]
    image_f: jnp.ndarray,  # [H,W]
    gx: jnp.ndarray,
    gy: jnp.ndarray,
    carry,  # (m [B,r,3], rho [B], last_rho [B], it [B], ok [B][, lazy])
    motion_type: MotionType,
    num_iters: int,
    eps,
    slab_iters: Optional[int],
    kernel: bool,
    mode: str = "forward",
    pre_mask: Optional[jnp.ndarray] = None,
) -> tuple:
    """Explicitly-batched Gauss-Newton ECC slab.  With ``kernel`` each
    iteration is ONE fused Triton sweep (ops/ecc_triton.py) that warps,
    masks, builds the Jacobian and reduces to ~66 raw sums per lane —
    no image-sized intermediate is written.  The XLA path materialises
    [B,3,H,W] warps plus a [B,P,H,W] Jacobian stack and is the exact
    reference.

    ``mode='lazy'`` (kernel only; the XLA path always runs the exact
    forward formulation) computes each lane's Jacobian Gram on its
    first active iteration and carries it: the carry then has two
    extra entries (hessian [B,P,P], h_ok [B]).

    ``pre_mask``: OpenCV inputMask support — the preprocessed binary
    mask (see :func:`_ecc_prepare_input_masked_jit`) is warped with
    INTER_NEAREST + BORDER_CONSTANT(0) by each lane's current warp and
    replaces the all-ones validity mask in the zero-mean statistics,
    exactly like ecc.cpp's per-iteration
    ``warpAffine(preMaskFloat, imageMask, map, maskFlags)``; the kernel
    takes it as a 4th source plane."""
    b, hd, wd = templates_f.shape
    hs, ws = image_f.shape
    xg = jnp.arange(wd, dtype=jnp.float32)[None, :] * jnp.ones(
        (hd, 1), dtype=jnp.float32
    )
    yg = jnp.arange(hd, dtype=jnp.float32)[:, None] * jnp.ones(
        (1, wd), dtype=jnp.float32
    )
    n_params = motion_type.num_params
    perspective = motion_type == MotionType.Homography
    srcs = jnp.stack([image_f, gx, gy])  # [3,H,W] shared across lanes
    lazy = kernel and mode == "lazy"
    if kernel:
        # the kernel uses one extent for the output grid and the source
        # bounds — true for every ECC path (template and input are the
        # same size; the callers check)
        assert (hd, wd) == (hs, ws), (templates_f.shape, image_f.shape)
        if pre_mask is not None:
            srcs = jnp.concatenate([srcs, pre_mask[None]], axis=0)

    def warp_all(m3b):
        # [B,3,H,W]: every lane warps the 3 shared sources with its
        # matrix (XLA-gather reference path)
        def one_lane(m3):
            if perspective:
                f = lambda s: warp.warp_perspective(
                    s, m3, (hd, wd), border_mode="constant",
                    border_value=0.0, inverse_map=True,
                )
            else:
                f = lambda s: warp.warp_affine(
                    s, m3[:2], (hd, wd), border_mode="constant",
                    border_value=0.0, inverse_map=True,
                )
            return jax.vmap(f)(srcs)

        return jax.vmap(one_lane)(m3b)

    update_fn = jax.vmap(
        lambda mm, dp: _update_warp(motion_type, mm, dp)
    )

    def kernel_moments(m3, active, with_hessian):
        from . import ecc_triton

        mom = ecc_triton.ecc_iteration_moments(
            srcs, templates_f, m3, active, motion_type=motion_type,
            quant_affine=not perspective, with_hessian=with_hessian,
        )
        return ecc_triton.unpack_moments(mom, motion_type, with_hessian)

    def iter_body(c, _):
        m, rho, last_rho, it, ok = c[:5]
        extras = c[5:]
        active = (it < num_iters) & (jnp.abs(rho - last_rho) >= eps) & ok
        if slab_iters is not None:
            active = active & (it < it_slab_end)
        m3 = jax.vmap(_as_3x3)(m)

        if kernel:
            # OpenCV's quantities are rebuilt from the kernel's raw sums
            # (exact identities, see ops/ecc_triton.py)
            if lazy:
                # Lazy-Hessian forward: the Jacobian Gram varies by
                # O(sub-pixel warp change) between iterations, so it is
                # computed on each lane's first active iteration and
                # CARRIED — the per-iteration sweep drops from 66 to 30
                # reductions (homography).  Same forward linearisation
                # and, because lambda is H-independent at the optimum,
                # the same fixed point; only the trajectory differs.
                hess_c, h_ok = extras
                need_h = active & ~h_ok

                def full_fn(_):
                    o = kernel_moments(m3, active, True)
                    return o[:6] + o[7:], o[6]

                def lite_fn(_):
                    o = kernel_moments(m3, active, False)
                    return o[:6] + o[7:], jnp.zeros_like(hess_c)

                (n_raw, s_mi, s_mii, s_mt, s_mtt, s_mti, j_i, j_m,
                 j_mt), hess_new = jax.lax.cond(
                    jnp.any(need_h), full_fn, lite_fn, None
                )
                hess_c = jnp.where(need_h[:, None, None], hess_new, hess_c)
                extras = (hess_c, h_ok | active)
                hessian = hess_c
            else:
                (n_raw, s_mi, s_mii, s_mt, s_mtt, s_mti,
                 hessian, j_i, j_m, j_mt) = kernel_moments(m3, active, True)
            n = jnp.maximum(n_raw, 1.0)
            img_mean = s_mi / n
            img_std = jnp.sqrt(jnp.maximum(s_mii / n - img_mean**2, 0.0))
            tmp_mean = s_mt / n
            tmp_std = jnp.sqrt(jnp.maximum(s_mtt / n - tmp_mean**2, 0.0))
            img_norm = jnp.sqrt(n) * img_std
            tmp_norm = jnp.sqrt(n) * tmp_std
            correlation = (
                s_mti - img_mean * s_mt - tmp_mean * s_mi
                + tmp_mean * img_mean * n_raw
            )
            image_proj = j_i - img_mean[:, None] * j_m
            template_proj = j_mt - tmp_mean[:, None] * j_m
        else:
            warped = warp_all(m3)
            image_warped = warped[:, 0]
            gxw = warped[:, 1]
            gyw = warped[:, 2]
            if pre_mask is not None:
                # user inputMask: nearest-warp the preprocessed binary
                # mask with the current warp — out-of-bounds pixels
                # land on the constant-0 border, so this subsumes the
                # validity mask (OpenCV relies on the same fact)
                if perspective:
                    warp_m = lambda mm: warp.warp_perspective(
                        pre_mask, mm, (hd, wd), border_mode="constant",
                        border_value=0.0, inverse_map=True,
                        interpolation=constants.INTER_NEAREST,
                    )
                else:
                    warp_m = lambda mm: warp.warp_affine(
                        pre_mask, mm[:2], (hd, wd),
                        border_mode="constant", border_value=0.0,
                        inverse_map=True,
                        interpolation=constants.INTER_NEAREST,
                    )
                mask = jax.vmap(warp_m)(m3)
            else:
                mask = jax.vmap(
                    lambda mm: warp.warp_valid_mask(mm, (hs, ws), (hd, wd),
                                                    inverse_map=True)
                )(m3)
            n = jnp.maximum(jnp.sum(mask, axis=(1, 2)), 1.0)  # [B]

            def mstats(x):
                mean = jnp.sum(x * mask, axis=(1, 2)) / n
                var = jnp.sum(
                    mask * (x - mean[:, None, None]) ** 2, axis=(1, 2)
                ) / n
                return mean, jnp.sqrt(var)

            img_mean, img_std = mstats(image_warped)
            tmp_mean, tmp_std = mstats(templates_f)
            image_zm = jnp.where(
                mask > 0, image_warped - img_mean[:, None, None],
                image_warped,
            )
            template_zm = mask * (templates_f - tmp_mean[:, None, None])
            img_norm = jnp.sqrt(n) * img_std
            tmp_norm = jnp.sqrt(n) * tmp_std

            jac = _jacobian_fields_batched(motion_type, gxw, gyw, xg, yg, m3)
            jflat = jac.reshape(b, n_params, -1)
            hessian = jnp.einsum(
                "bpx,bqx->bpq", jflat, jflat, precision=_HIGHEST
            )

            izm = image_zm.reshape(b, -1)
            tzm = template_zm.reshape(b, -1)
            correlation = jnp.sum(tzm * izm, axis=1)
            image_proj = jnp.einsum(
                "bpx,bx->bp", jflat, izm, precision=_HIGHEST
            )
            template_proj = jnp.einsum(
                "bpx,bx->bp", jflat, tzm, precision=_HIGHEST
            )

        hessian_inv = jnp.linalg.inv(hessian)
        new_rho = correlation / (img_norm * tmp_norm)
        iph = jnp.einsum(
            "bpq,bq->bp", hessian_inv, image_proj, precision=_HIGHEST
        )
        lambda_n = img_norm**2 - jnp.sum(image_proj * iph, axis=1)
        lambda_d = correlation - jnp.sum(template_proj * iph, axis=1)
        failed = jnp.isnan(new_rho) | (lambda_d <= 0.0)
        lam = lambda_n / jnp.where(lambda_d == 0.0, 1.0, lambda_d)

        # err = lam * template_zm - image_zm, so its Jacobian projection
        # is the exact linear combination — no third image-sized pass
        error_proj = lam[:, None] * template_proj - image_proj
        dp = jnp.einsum(
            "bpq,bq->bp", hessian_inv, error_proj, precision=_HIGHEST
        )
        new_m = update_fn(m, dp)
        new_m = jnp.where(failed[:, None, None], m, new_m)

        upd = (active & ~failed)[:, None, None]
        out = (
            jnp.where(upd, new_m, m),
            jnp.where(active,
                      jnp.where(failed, jnp.float32(-1.0),
                                new_rho.astype(jnp.float32)), rho),
            jnp.where(active, rho, last_rho),
            jnp.where(active, it + 1, it),
            ok & ~(active & failed),
        ) + extras
        return out, None

    def chunk_body(c):
        c, _ = jax.lax.scan(
            iter_body, c, None, length=_CHUNK_ITERS, unroll=_CHUNK_ITERS
        )
        return c

    def chunk_cond(c):
        m, rho, last_rho, it, ok = c[:5]
        active = (it < num_iters) & (jnp.abs(rho - last_rho) >= eps) & ok
        if slab_iters is not None:
            active = active & (it < it_slab_end)
        return jnp.any(active)

    it_slab_end = carry[3] + (slab_iters if slab_iters is not None else 0)
    return jax.lax.while_loop(chunk_cond, chunk_body, carry)


@functools.partial(jax.jit, static_argnames=("gauss_filt_size",))
def _ecc_prepare_input_jit(input_image, gauss_filt_size):
    """Input-side fields (blur + gradients) — shared by every lane
    group, computed once per burst."""
    return _input_fields(input_image, gauss_filt_size)


@functools.partial(
    jax.jit, static_argnames=("motion_type", "gauss_filt_size", "lazy")
)
def _ecc_prepare_templates_jit(
    templates, gauss_filt_size, motion_type, lazy=False
):
    """Per-group template blur + fresh solve carry."""
    templates_f = filters.gaussian_blur(
        templates.astype(jnp.float32), gauss_filt_size
    )
    n = templates_f.shape[0]
    warp0 = identity_warp(motion_type)
    carry = (
        jnp.tile(warp0[None], (n, 1, 1)),
        jnp.full((n,), -1.0, jnp.float32),
        jnp.zeros((n,), jnp.float32),  # filled with -eps by caller
        jnp.zeros((n,), jnp.int32),
        jnp.ones((n,), bool),
    )
    if lazy:
        p = motion_type.num_params
        carry = carry + (
            jnp.zeros((n, p, p), jnp.float32),  # carried Jacobian Gram
            jnp.zeros((n,), bool),  # h_ok: Gram computed for this lane
        )
    return templates_f, carry


@functools.partial(
    jax.jit,
    static_argnames=("motion_type", "num_iters", "slab_iters", "kernel",
                     "mode"),
)
def _ecc_slab_jit(
    templates_f, image_f, gx, gy, carry, motion_type, num_iters, eps,
    slab_iters, kernel=False, mode="forward", pre_mask=None,
):
    new_c = _ecc_loop_batched(
        templates_f, image_f, gx, gy, carry, motion_type, num_iters, eps,
        slab_iters, kernel, mode, pre_mask,
    )
    m, rho, last_rho, it, ok = new_c[:5]
    done = (it >= num_iters) | (jnp.abs(rho - last_rho) < eps) | ~ok
    res = EccResult(rho=rho, warp_matrix=m, ok=ok, num_iters=it)
    return res, new_c, done


def _rescale_warp_batch(
    warps: jnp.ndarray, motion_type: MotionType, s: float
) -> jnp.ndarray:
    """Upscale warp matrices estimated on a 1/s-scale grid to full scale
    (translation column scales; homography perspective row divides —
    same math as the reference's scale-down adjustment,
    src/lib.rs:941-958)."""
    w = warps.at[..., 0, 2].mul(s).at[..., 1, 2].mul(s)
    if motion_type == MotionType.Homography:
        w = w.at[..., 2, 0].divide(s).at[..., 2, 1].divide(s)
    return w


@functools.partial(jax.jit, static_argnames=("dh", "dw"))
def _resize_area_jit(x: jnp.ndarray, dh: int, dw: int) -> jnp.ndarray:
    """Jitted INTER_AREA resize for the coarse-to-fine octaves.

    Exact 2x reductions of even extents (every octave step at even
    dims) are a 2x2 box mean — INTER_AREA's weights for an integer 2x
    ratio are exactly uniform 1/4 — computed as one reshape-mean at
    memory bandwidth instead of two banded matmuls.
    Everything else (odd extents) takes the exact banded-resize path;
    under jit XLA fuses its shifted-slice operands instead of
    materialising the [nblk, L, ...] stack an eager call pays."""
    h, w = x.shape[-2], x.shape[-1]
    if h == 2 * dh and w == 2 * dw:
        x4 = x.reshape(*x.shape[:-2], dh, 2, dw, 2)
        return (x4[..., 0, :, 0] + x4[..., 0, :, 1]
                + x4[..., 1, :, 0] + x4[..., 1, :, 1]) * jnp.float32(0.25)
    from . import resize as _resize

    return _resize.resize(x, (dh, dw), constants.INTER_AREA)


def _resize_batch_chunked(x: jnp.ndarray, dh: int, dw: int) -> jnp.ndarray:
    """Lane-chunked jitted resize of a [N,H,W] burst: bounds the jitted
    program's transients (~4 HW-sized f32 buffers per lane) to an
    eighth of the device's memory."""
    n, h, w = x.shape
    if h == 2 * dh and w == 2 * dw:
        # box-mean path: one fused bandwidth-bound reduce, no HW-sized
        # transients to bound
        return _resize_area_jit(x, dh, dw)
    from ..utils.device import device_bytes_limit

    chunk = max(1, device_bytes_limit() // 8 // (h * w * 16))
    if chunk >= n:
        return _resize_area_jit(x, dh, dw)
    return jnp.concatenate([
        _resize_area_jit(x[i : i + chunk], dh, dw)
        for i in range(0, n, chunk)
    ])


def find_transform_ecc_batched(
    templates: jnp.ndarray,
    input_image: jnp.ndarray,
    motion_type: MotionType = MotionType.Affine,
    num_iters: int = 200,
    eps: float = -1.0,
    gauss_filt_size: int = 5,
    slab_iters: Optional[int] = None,
    coarse_levels: int = 0,
    warp_init: Optional[jnp.ndarray] = None,
    mode: Optional[str] = None,
    input_mask: Optional[jnp.ndarray] = None,
    rho_init: Optional[jnp.ndarray] = None,
) -> EccResult:
    """Batched ECC: estimate one warp per template frame against a shared
    input image (the reference's per-thread ``find_transform_ecc`` calls
    at src/lib.rs:769-777 collapsed into one vmapped program).

    ``rho_init`` ([N] f32, internal — the coarse-to-fine driver) seeds
    each lane's ``last_rho`` with the previous octave's converged
    correlation, so OpenCV's |d rho| < eps stopping rule is applied
    ACROSS the scale change: a lane whose first iteration here measures
    the same rho its octave converged at stops after that one polishing
    iteration.  Lanes marked -1 (no trustworthy octave rho) keep the
    cold start.  Ignored when eps <= 0.

    Host-level driver: lanes are solved in groups sized to the device's
    memory (:func:`_lanes_per_group`).  By default each group's whole
    solve is one device program (measured fastest on the H100: one
    program per solve against 4-iteration slabs, PERF.md);
    ``slab_iters`` bounds the Gauss-Newton iterations per program, with
    convergence read on the host between programs.

    ``coarse_levels`` > 0 enables coarse-to-fine solving (a capability
    beyond OpenCV's findTransformECC): the warp is first estimated on
    2x-downscaled octaves, then refined at full resolution from that
    init — same converged warp, a fraction of the full-res iterations.

    ``mode``: 'forward' (OpenCV's forward-additive formulation — the
    default) or 'lazy' (see :func:`_ecc_mode_default`).  ``None``
    resolves via LIBSTACKER_ECC_MODE.  The XLA path always runs the
    exact forward formulation.

    ``input_mask`` ([H,W], nonzero = valid) is cv2.findTransformECC's
    ``inputMask``: pixels of ``input_image`` excluded from the
    correlation (moving subjects, dead sensor regions).  Semantics
    match ecc.cpp exactly — the mask is binarised, blurred with
    ``gauss_filt_size`` and re-thresholded at 0.95, the input
    gradients are pre-multiplied by it, and every iteration
    nearest-warps it in place of the all-ones validity mask (on a GPU
    as the fused kernel's 4th source plane).
    """
    import os

    mode = _check_mode(_ecc_mode_default() if mode is None else mode)
    if coarse_levels > 0:
        n, h, w = templates.shape
        # Octave pyramid by CASCADED 2x INTER_AREA reductions, shallow
        # (s=2) -> deep: each level resizes the previous one (4x
        # cheaper per level than re-resizing the full-res burst, exact
        # for even extents and sub-LSB different otherwise — the
        # octaves only seed the next level's warm start).  The burst
        # resize is jitted and lane-chunked (an eager banded resize
        # materialises its [nblk, L, N, W] slice stack).
        levels = [
            lvl for lvl in range(1, coarse_levels + 1)
            if min(h, w) // 2 ** lvl >= 64
        ]
        octaves = {}
        tl, il = templates, input_image
        ml = (
            None if input_mask is None
            else (jnp.asarray(input_mask) > 0).astype(jnp.float32)
        )
        for lvl in range(1, (max(levels) + 1) if levels else 1):
            s = 2 ** lvl
            dh, dw = h // s, w // s
            tl = _resize_batch_chunked(tl, dh, dw)
            il = _resize_area_jit(il, dh, dw)
            if ml is not None:
                ml = _resize_area_jit(ml, dh, dw)
            if lvl in levels:
                # conservative mask downscale: a coarse pixel is valid
                # only if >= half its INTER_AREA footprint was
                octaves[lvl] = (tl, il, None if ml is None else ml >= 0.5)
        init = warp_init
        init_at_full_scale = warp_init is not None
        # Octave solves only seed the finer level's warm start, so they
        # may run to a looser tolerance than the user's eps (the
        # full-resolution solve below always uses the exact criteria).
        # LIBSTACKER_COARSE_EPS_MULT sets the factor.
        eps_oct = eps
        if eps > 0:
            eps_oct = eps * float(
                os.environ.get("LIBSTACKER_COARSE_EPS_MULT", "1")
            )
        rho_seed = None
        for lvl in sorted(octaves, reverse=True):
            s = 2 ** lvl
            tl, il, mlv = octaves[lvl]
            if init_at_full_scale:
                # the caller's warp_init (e.g. the phase-correlation
                # warm start) is in full-resolution pixels; bring it to
                # the first actually-solved octave's grid (levels after
                # this one are handled by the 2.0 rescale below)
                init = _rescale_warp_batch(init, motion_type, 1.0 / s)
                init_at_full_scale = False
            res = find_transform_ecc_batched(
                tl, il, motion_type, num_iters, eps_oct, gauss_filt_size,
                coarse_levels=0, warp_init=init, mode=mode, input_mask=mlv,
            )
            wm, rho_o, ok_o = res.warp_matrix, res.rho, res.ok
            init = _rescale_warp_batch(wm, motion_type, 2.0)
            # cross-scale rho seed for the next level's convergence
            # test: a lane whose octave solve converged hands its final
            # correlation down — if the finer level's first iteration
            # measures the same rho (|d rho| < eps, OpenCV's own
            # criterion applied across the scale change), the lane
            # stops after ONE polishing iteration instead of paying a
            # second confirm sweep.  Lanes without a trustworthy octave
            # rho (failed/frozen) keep the default cold start.
            rho_seed = jnp.where(
                ok_o & (rho_o > -1.0), rho_o, jnp.float32(-1.0)
            )
        if os.environ.get("LIBSTACKER_COARSE_RHO_SEED", "1") == "0":
            rho_seed = None
        return find_transform_ecc_batched(
            templates, input_image, motion_type, num_iters, eps,
            gauss_filt_size, slab_iters=slab_iters, coarse_levels=0,
            warp_init=init, mode=mode, input_mask=input_mask,
            rho_init=rho_seed,
        )

    n, h, w = templates.shape
    if n == 0:
        # empty lane set (e.g. a 1-frame burst's frames[1:]): nothing to
        # solve — return empty, well-shaped results instead of tracing a
        # zero-lane program
        r = 3 if motion_type == MotionType.Homography else 2
        return EccResult(
            rho=jnp.zeros((0,), jnp.float32),
            warp_matrix=jnp.zeros((0, r, 3), jnp.float32),
            ok=jnp.zeros((0,), bool),
            num_iters=jnp.zeros((0,), jnp.int32),
        )
    kernel = _kernel_ok(h, w) and tuple(input_image.shape) == (h, w)
    lazy = kernel and mode == "lazy"
    group_n = _lanes_per_group(h, w, kernel)
    pre_mask = None
    if input_mask is not None:
        input_mask = jnp.asarray(input_mask)
        if input_mask.shape != input_image.shape:
            raise ValueError(
                f"input_mask shape {input_mask.shape} must match "
                f"input_image shape {input_image.shape}"
            )
        image_f, gx, gy, pre_mask = _ecc_prepare_input_masked_jit(
            input_image, input_mask, gauss_filt_size
        )
    else:
        image_f, gx, gy = _ecc_prepare_input_jit(
            input_image, gauss_filt_size
        )

    groups = []
    for s0 in range(0, n, group_n):
        e0 = min(s0 + group_n, n)
        templates_f, carry = _ecc_prepare_templates_jit(
            templates[s0:e0], gauss_filt_size, motion_type, lazy=lazy
        )
        if warp_init is not None:
            carry = (
                jnp.asarray(warp_init[s0:e0], jnp.float32),
            ) + carry[1:]
        if rho_init is not None and eps > 0:
            r0 = jnp.asarray(rho_init[s0:e0], jnp.float32)
            valid = r0 > -1.0
            # seeded lanes: rho = octave rho, last_rho 2*eps below it so
            # the first iteration always runs; unseeded lanes keep the
            # (-1, 0) cold start (the -eps shift below applies to both)
            carry = (
                carry[0],
                jnp.where(valid, r0, carry[1]),
                jnp.where(valid, r0 - jnp.float32(eps), carry[2]),
            ) + carry[3:]
        carry = (carry[0], carry[1], carry[2] - eps) + carry[3:]
        groups.append([templates_f, carry, None])

    # Every group's slab loop is driven interleaved: each dispatch is
    # async, so a whole round of slabs across every group costs ONE host
    # sync.  The number of slabs dispatched per round grows
    # geometrically — a drained (all-lanes-inactive) slab is nearly free
    # on device, so overshooting beats extra syncs.
    pend = list(range(len(groups)))
    disp = 1
    while pend:
        flags = []
        for gi in pend:
            g = groups[gi]
            for _ in range(disp):
                g[2], g[1], done = _ecc_slab_jit(
                    g[0], image_f, gx, gy, g[1], motion_type, num_iters,
                    eps, slab_iters, kernel=kernel, mode=mode,
                    pre_mask=pre_mask,
                )
            flags.append(jnp.all(done))
        done_np = jax.device_get(jnp.stack(flags))
        pend = [gi for gi, d in zip(pend, done_np) if not bool(d)]
        disp = min(disp * 2, 8)

    res = [g[2] for g in groups]
    return EccResult(
        rho=jnp.concatenate([r.rho for r in res]),
        warp_matrix=jnp.concatenate([r.warp_matrix for r in res]),
        ok=jnp.concatenate([r.ok for r in res]),
        num_iters=jnp.concatenate([r.num_iters for r in res]),
    )


def _kernel_ok(h: int, w: int) -> bool:
    """Run each iteration as the fused Triton kernel (ops/ecc_triton.py)
    on a GPU, for images of at least one kernel program's worth of
    pixels; smaller images and other backends take the XLA path."""
    from . import ecc_triton

    return (
        jax.default_backend() == "gpu"
        and h * w >= ecc_triton.PIXELS_PER_PROGRAM
    )

"""Masked ECC (cv2.findTransformECC's ``inputMask``) parity and
semantics.

The reference crate re-exports the whole opencv crate (src/lib.rs:19),
so its users can call find_transform_ecc with an input mask directly;
this framework exposes the same capability through
``find_transform_ecc(..., input_mask=...)`` and the pipelines'
``mask=`` argument.  OpenCV semantics (ecc.cpp): binarise the mask,
Gaussian-blur + re-threshold at 0.95 (erode by the blur support),
pre-multiply the input gradients, and nearest-warp it per iteration in
place of the all-ones validity mask.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from libstacker_tpu.ops import ecc as ecc_ops
from libstacker_tpu.models.ecc import ecc_match_arrays
from libstacker_tpu.params import EccMatchParameters, MotionType

_CV_MOTION = {
    MotionType.Translation: cv2.MOTION_TRANSLATION,
    MotionType.Euclidean: cv2.MOTION_EUCLIDEAN,
    MotionType.Homography: cv2.MOTION_HOMOGRAPHY,
}


def _static_overlay_pair(h=96, w=128, seed=7):
    """A shifted textured scene with a STATIC high-contrast overlay
    block (same pixels in both frames — a watermark / dirty-lens
    region): the unmasked solver is pulled toward zero motion, the
    masked solver must recover the true shift (2.3, -1.7)."""
    rng = np.random.default_rng(seed)
    base = rng.random((h * 2, w * 2)).astype(np.float32)
    base = cv2.GaussianBlur(base, (0, 0), 3.0) * 255.0
    m = np.array([[1, 0, 2.3], [0, 1, -1.7]], np.float32)
    ref = base[h // 2 : h // 2 + h, w // 2 : w // 2 + w].copy()
    cur = cv2.warpAffine(
        base, m, (w * 2, h * 2),
        flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
    )[h // 2 : h // 2 + h, w // 2 : w // 2 + w].copy()
    bh, bw = h // 2, w // 2
    y0, x0 = h // 4, w // 4
    overlay = (rng.random((bh, bw)) > 0.5).astype(np.float32) * 255.0
    ref[y0 : y0 + bh, x0 : x0 + bw] = overlay
    cur[y0 : y0 + bh, x0 : x0 + bw] = overlay
    mask = np.full((h, w), 255, np.uint8)
    mask[y0 : y0 + bh, x0 : x0 + bw] = 0
    return ref.astype(np.uint8), cur.astype(np.uint8), mask


def _run_cv_masked(cur, ref, mask, motion, iters):
    crit = (cv2.TERM_CRITERIA_COUNT, iters, 0.0)
    wm = (
        np.eye(3, dtype=np.float32)
        if motion == MotionType.Homography
        else np.eye(2, 3, dtype=np.float32)
    )
    return cv2.findTransformECC(
        cur, ref, wm, _CV_MOTION[motion], crit, mask, 5
    )


def test_premask_matches_cv2():
    """Pre-mask construction (threshold -> blur -> *0.5/0.95 -> round)
    is bit-identical to ecc.cpp's."""
    rng = np.random.default_rng(11)
    h, w = 64, 80
    mask = np.zeros((h, w), np.uint8)
    # a few random rectangles of validity
    for _ in range(5):
        y, x = rng.integers(0, h - 12), rng.integers(0, w - 12)
        mask[y : y + rng.integers(6, 20), x : x + rng.integers(6, 20)] = 255
    for g in (3, 5):
        pre_cv = cv2.threshold(mask, 0, 1, cv2.THRESH_BINARY)[1].astype(
            np.float32
        )
        pre_cv = cv2.GaussianBlur(pre_cv, (g, g), 0, 0) * (0.5 / 0.95)
        pre_cv = np.rint(pre_cv)  # convertTo's cvRound (half-to-even)
        img = rng.random((h, w)).astype(np.float32) * 255.0
        _, _, _, pre_us = ecc_ops._ecc_prepare_input_masked_jit(
            jnp.asarray(img), jnp.asarray(mask), g
        )
        np.testing.assert_array_equal(np.asarray(pre_us), pre_cv)


@pytest.mark.parametrize(
    "motion", [MotionType.Translation, MotionType.Euclidean]
)
def test_masked_ecc_matches_cv2(motion):
    ref, cur, mask = _static_overlay_pair()
    rho_cv, m_cv = _run_cv_masked(cur, ref, mask, motion, 30)
    res = ecc_ops.find_transform_ecc(
        jnp.asarray(cur), jnp.asarray(ref), motion_type=motion,
        num_iters=30, eps=-1.0, gauss_filt_size=5,
        input_mask=jnp.asarray(mask),
    )
    assert bool(res.ok)
    m_us = np.asarray(res.warp_matrix)
    np.testing.assert_allclose(m_us[:, 2], m_cv[:, 2], atol=5e-2)
    np.testing.assert_allclose(m_us[:, :2], m_cv[:, :2], atol=2e-3)
    assert float(res.rho) == pytest.approx(rho_cv, abs=2e-2)


def _gentle_homography_pair(h=96, w=128, seed=7):
    """A small static overlay (1/36 of the frame) and a mild projective
    warp: well-enough conditioned that the masked homography solve is a
    fair quality comparison (the 25%-overlay scenario's rho landscape is
    multi-modal for 8-dof motion — BOTH implementations oscillate there,
    in different directions; see CLAUDE.md's aliasing-trap note)."""
    rng = np.random.default_rng(seed)
    base = rng.random((h * 2, w * 2)).astype(np.float32)
    base = cv2.GaussianBlur(base, (0, 0), 3.0) * 255.0
    m = np.array(
        [[1.004, 0.006, 1.4], [-0.004, 0.998, -0.9], [1e-5, -6e-6, 1.0]],
        np.float32,
    )
    ref = base[h // 2 : h // 2 + h, w // 2 : w // 2 + w].copy()
    cur = cv2.warpPerspective(
        base, m, (w * 2, h * 2),
        flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
    )[h // 2 : h // 2 + h, w // 2 : w // 2 + w].copy()
    bh, bw = h // 6, w // 6
    y0, x0 = h // 3, w // 3
    ov = (rng.random((bh, bw)) > 0.5).astype(np.float32) * 255.0
    ref[y0 : y0 + bh, x0 : x0 + bw] = ov
    cur[y0 : y0 + bh, x0 : x0 + bw] = ov
    mask = np.full((h, w), 255, np.uint8)
    mask[y0 : y0 + bh, x0 : x0 + bw] = 0
    return ref.astype(np.uint8), cur.astype(np.uint8), mask


def test_masked_ecc_homography_matches_cv2():
    """8-dof masked parity: the FIRST iteration is near-bit-exact
    (semantic equivalence — every mask decision identical); after a
    fixed budget the solve QUALITY (rho) matches cv2 (per-iterate
    equality is chaotic on synthetic double-resampled content, where
    the rho landscape is multi-modal — both solvers oscillate)."""
    ref, cur, mask = _gentle_homography_pair()
    _, m_cv1 = _run_cv_masked(cur, ref, mask, MotionType.Homography, 1)
    res1 = ecc_ops.find_transform_ecc(
        jnp.asarray(cur), jnp.asarray(ref),
        motion_type=MotionType.Homography,
        num_iters=1, eps=-1.0, gauss_filt_size=5,
        input_mask=jnp.asarray(mask),
    )
    np.testing.assert_allclose(
        np.asarray(res1.warp_matrix), m_cv1, atol=1e-3
    )

    rho_cv, _ = _run_cv_masked(cur, ref, mask, MotionType.Homography, 30)
    res = ecc_ops.find_transform_ecc(
        jnp.asarray(cur), jnp.asarray(ref),
        motion_type=MotionType.Homography,
        num_iters=30, eps=-1.0, gauss_filt_size=5,
        input_mask=jnp.asarray(mask),
    )
    assert bool(res.ok)
    assert float(res.rho) == pytest.approx(rho_cv, abs=0.05)


def test_mask_recovers_truth_where_unmasked_is_pulled():
    ref, cur, mask = _static_overlay_pair()
    kw = dict(
        motion_type=MotionType.Translation, num_iters=100, eps=1e-6,
        gauss_filt_size=5,
    )
    res_m = ecc_ops.find_transform_ecc(
        jnp.asarray(cur), jnp.asarray(ref), input_mask=jnp.asarray(mask),
        **kw,
    )
    res_u = ecc_ops.find_transform_ecc(jnp.asarray(cur), jnp.asarray(ref),
                                       **kw)
    truth = np.array([2.3, -1.7])
    err_m = np.abs(np.asarray(res_m.warp_matrix)[:, 2] - truth).max()
    err_u = np.abs(np.asarray(res_u.warp_matrix)[:, 2] - truth).max()
    assert bool(res_m.ok)
    # ~0.2 px residual pull is inherent to OpenCV's mask semantics (the
    # pre-mask erodes by the blur support only, so template pixels just
    # past the warped mask edge still hold ~2 px of static overlay);
    # the masked-parity test above pins us to cv2 within 5e-2 anyway
    assert err_m < 0.3, err_m
    # the static overlay covers 25% of the frame: the unmasked solve is
    # measurably dragged toward zero motion
    assert err_u > 2 * max(err_m, 0.02), (err_m, err_u)


def test_ecc_match_arrays_mask_pipeline():
    """Pipeline-level mask: a burst with a static overlay aligns to the
    true integer shifts only when the overlay is masked."""
    rng = np.random.default_rng(23)
    h, w = 96, 128
    base = rng.random((h, w, 3)).astype(np.float32)
    base = cv2.GaussianBlur(base, (0, 0), 2.0)
    base = (base * 255).astype(np.uint8)
    shifts = [(0, 0), (3, -2), (-2, 4)]
    frames = np.stack(
        [np.roll(base, s, axis=(0, 1)) for s in shifts]
    )
    bh, bw = h // 2, w // 2
    y0, x0 = h // 4, w // 4
    overlay = ((rng.random((bh, bw, 3)) > 0.5) * 255).astype(np.uint8)
    frames[:, y0 : y0 + bh, x0 : x0 + bw] = overlay  # static in all frames
    mask = np.full((h, w), 255, np.uint8)
    mask[y0 : y0 + bh, x0 : x0 + bw] = 0

    params = EccMatchParameters(
        motion_type=MotionType.Translation, max_count=100, epsilon=1e-5
    )
    out, stats = ecc_match_arrays(
        frames, params, return_stats=True, mask=mask
    )
    assert out.shape == (h, w, 3)
    assert stats.frames_kept == 3
    # masked alignment recovers the roll shifts -> outside the overlay
    # the stack matches frame 0 closely (interior crop, away from the
    # roll wrap-around and the masked block)
    crop = np.s_[8 : y0 - 4, x0 + bw + 8 : w - 8]
    ref_f = frames[0].astype(np.float32) / 255.0
    err = np.abs(out[crop] - ref_f[crop]).mean()
    assert err < 0.02, err

    # scaled path exercises the mask downscale
    out_s = ecc_match_arrays(
        frames, params, scale_down_width=float(h // 2), mask=mask
    )
    err_s = np.abs(out_s[crop] - ref_f[crop]).mean()
    assert err_s < 0.04, err_s


def _masked_reference_moments(tmpl, image_f, gx, gy, pre, m3, motion_type):
    """Masked moments from the XLA fields — mirrors what the masked
    _ecc_loop_batched XLA branch builds (gx/gy already pre-multiplied
    by ``pre``; the stats mask is the INTER_NEAREST warp of ``pre``)."""
    import jax.numpy as jnp
    from libstacker_tpu import constants
    from libstacker_tpu.ops import ecc as ecc_ops
    from libstacker_tpu.ops import warp

    h, w = image_f.shape
    perspective = motion_type == MotionType.Homography

    def wt(img, interp=constants.INTER_LINEAR):
        if perspective:
            return warp.warp_perspective(
                img, m3, (h, w), border_mode="constant", border_value=0.0,
                inverse_map=True, interpolation=interp,
            )
        return warp.warp_affine(
            img, m3[:2], (h, w), border_mode="constant", border_value=0.0,
            inverse_map=True, interpolation=interp,
        )

    imw = np.asarray(wt(image_f))
    gxw = np.asarray(wt(gx))
    gyw = np.asarray(wt(gy))
    mask = np.asarray(wt(pre, interp=constants.INTER_NEAREST))
    xg = np.arange(w, dtype=np.float32)[None, :] * np.ones((h, 1), np.float32)
    yg = np.arange(h, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    jac = np.asarray(
        ecc_ops._jacobian_fields_batched(
            motion_type, jnp.asarray(gxw)[None], jnp.asarray(gyw)[None],
            jnp.asarray(xg), jnp.asarray(yg), jnp.asarray(m3)[None],
        )
    )[0]
    p = jac.shape[0]
    out = [
        mask.sum(),
        (mask * imw).sum(),
        (mask * imw * imw).sum(),
        (mask * tmpl).sum(),
        (mask * tmpl * tmpl).sum(),
        (mask * tmpl * imw).sum(),
    ]
    for a in range(p):
        out.append((jac[a] * imw).sum())
    for a in range(p):
        out.append((jac[a] * mask).sum())
    for a in range(p):
        out.append((jac[a] * mask * tmpl).sum())
    for a in range(p):
        for b in range(a, p):
            out.append((jac[a] * jac[b]).sum())
    return np.asarray(out, np.float64)


@pytest.mark.parametrize(
    "motion", [MotionType.Translation, MotionType.Homography]
)
def test_masked_kernel_moments_match_xla_fields(motion):
    """The fused kernel's 4th-plane nearest mask tap reproduces the XLA
    masked branch's moments (interpret mode)."""
    import jax.numpy as jnp
    from libstacker_tpu.ops import ecc as ecc_ops
    from libstacker_tpu.ops import ecc_triton

    rng = np.random.default_rng(17)
    h, w = 192, 512
    img = cv2.GaussianBlur(
        (rng.random((h, w)) * 255).astype(np.float32), (0, 0), 2.0
    )
    tmpl = cv2.GaussianBlur(
        (rng.random((h, w)) * 255).astype(np.float32), (0, 0), 2.0
    )
    user_mask = np.full((h, w), 255, np.uint8)
    user_mask[60:130, 180:330] = 0
    user_mask[10:40, 30:90] = 0

    image_f, gx, gy, pre = ecc_ops._ecc_prepare_input_masked_jit(
        jnp.asarray(img), jnp.asarray(user_mask), 5
    )
    m3 = np.array(
        [[1.002, 0.004, 2.25], [-0.003, 0.999, -1.5], [0, 0, 1]],
        np.float32,
    )
    if motion == MotionType.Homography:
        m3[2, :2] = (1e-5, -6e-6)
    perspective = motion == MotionType.Homography

    srcs = jnp.stack([image_f, gx, gy, pre])
    got = np.asarray(
        ecc_triton.ecc_iteration_moments(
            srcs, jnp.asarray(tmpl)[None], jnp.asarray(m3)[None],
            jnp.ones((1,), bool), motion_type=motion,
            quant_affine=not perspective, interpret=True,
        )
    )[0]
    want = _masked_reference_moments(
        tmpl, image_f, gx, gy, pre, jnp.asarray(m3), motion
    )
    assert got.shape == want.shape
    # stats moments (incl. the mask pixel count) agree to f32 reduction
    # order, like test_ecc_kernel.test_moments_match_xla_fields
    np.testing.assert_allclose(got[:6], want[:6], rtol=1e-5, atol=1e-2)
    # Jacobian moments: the kernel and XLA compute source coords with
    # different f32 op orders, so a handful of pixels on exact rounding
    # boundaries flip their nearest tap — unmasked that is one
    # interpolation step, but at a mask edge it flips a whole 0/1 mask
    # value, perturbing the heavily-cancelled jac*mask sums by a few
    # percent (measured 4.7% worst on homography).  The end-to-end
    # masked fused solve below pins the warp itself to 2e-3.
    np.testing.assert_allclose(got, want, rtol=8e-2, atol=5e-2)


def test_masked_fused_solve_matches_xla(ecc_kernel_interpret):
    """End-to-end masked solve through the fused kernel (interpret
    mode) converges to the XLA masked path's warp."""
    import jax.numpy as jnp

    rng = np.random.default_rng(19)
    h, w = 192, 512
    base = cv2.GaussianBlur(
        (rng.random((h + 16, w + 16)) * 255).astype(np.float32), (0, 0), 2.0
    )
    ref = base[8 : 8 + h, 8 : 8 + w].astype(np.uint8)
    cur = base[5 : 5 + h, 10 : 10 + w].astype(np.uint8)  # shift (3, -2)
    mask = np.full((h, w), 255, np.uint8)
    mask[70:130, 200:320] = 0

    kw = dict(
        motion_type=MotionType.Translation, num_iters=50, eps=1e-5,
        gauss_filt_size=5, input_mask=jnp.asarray(mask),
    )
    with ecc_kernel_interpret.off():
        res_xla = ecc_ops.find_transform_ecc(
            jnp.asarray(cur), jnp.asarray(ref), **kw
        )
    res_k = ecc_ops.find_transform_ecc(
        jnp.asarray(cur), jnp.asarray(ref), **kw
    )
    assert bool(res_xla.ok) and bool(res_k.ok)
    np.testing.assert_allclose(
        np.asarray(res_k.warp_matrix), np.asarray(res_xla.warp_matrix),
        atol=2e-3,
    )
    assert float(res_k.rho) == pytest.approx(float(res_xla.rho), abs=1e-3)


def test_masked_kernel_moments_nonaligned_size():
    """Masked moments on an image whose pixel count is not a multiple of
    the kernel's block: the ragged last block's invalid pixels must
    stay out of every sum."""
    import jax.numpy as jnp
    from libstacker_tpu.ops import ecc as ecc_ops
    from libstacker_tpu.ops import ecc_triton

    rng = np.random.default_rng(29)
    h, w = 161, 400
    img = cv2.GaussianBlur(
        (rng.random((h, w)) * 255).astype(np.float32), (0, 0), 2.0
    )
    tmpl = cv2.GaussianBlur(
        (rng.random((h, w)) * 255).astype(np.float32), (0, 0), 2.0
    )
    user_mask = np.full((h, w), 255, np.uint8)
    user_mask[50:110, 150:280] = 0

    image_f, gx, gy, pre = ecc_ops._ecc_prepare_input_masked_jit(
        jnp.asarray(img), jnp.asarray(user_mask), 5
    )
    m3 = np.array(
        [[1.0, 0.0, 2.25], [0.0, 1.0, -1.5], [0, 0, 1]], np.float32
    )
    srcs = jnp.stack([image_f, gx, gy, pre])
    got = np.asarray(
        ecc_triton.ecc_iteration_moments(
            srcs, jnp.asarray(tmpl)[None], jnp.asarray(m3)[None],
            jnp.ones((1,), bool), motion_type=MotionType.Translation,
            quant_affine=True, interpret=True,
        )
    )[0]
    want = _masked_reference_moments(
        tmpl, image_f, gx, gy, pre, jnp.asarray(m3),
        MotionType.Translation,
    )
    np.testing.assert_allclose(got[:6], want[:6], rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(got, want, rtol=8e-2, atol=5e-2)


def test_mask_shape_validation():
    frames = np.zeros((2, 32, 48, 3), np.uint8)
    params = EccMatchParameters(
        motion_type=MotionType.Translation, max_count=5, epsilon=1e-4
    )
    from libstacker_tpu.errors import InvalidParamsError

    with pytest.raises(InvalidParamsError):
        ecc_match_arrays(frames, params, mask=np.ones((16, 16), np.uint8))

"""Fused ECC iteration kernel (ops/ecc_triton.py) against the XLA
fields path.

Here the kernel runs in the Pallas interpreter; its Triton lowering is
checked by lowering for CUDA (no card needed), and ``-m gpu`` runs it
compiled on a card.  The kernel returns the iteration's raw sums: the
tests check (a) the sums equal the ones built from the XLA
warp/mask/Jacobian fields, (b) a solve driven through the kernel lands
where the XLA solve lands, and (c) the choice of path.
"""

import numpy as np
import pytest
from scipy import ndimage

import jax
import jax.numpy as jnp

from libstacker_tpu.errors import InvalidParamsError
from libstacker_tpu.ops import ecc as ecc_ops
from libstacker_tpu.ops import ecc_triton, warp
from libstacker_tpu.params import MotionType

ALL_MOTIONS = [MotionType.Translation, MotionType.Euclidean,
               MotionType.Affine, MotionType.Homography]


def _rotation(cx, cy, angle_deg, scale):
    """cv2.getRotationMatrix2D as a 2x3 array (no cv2 on the card's
    machine, where the gpu test of this file runs)."""
    a = np.deg2rad(angle_deg)
    c, s = scale * np.cos(a), scale * np.sin(a)
    return np.array([[c, s, (1 - c) * cx - s * cy],
                     [-s, c, s * cx + (1 - c) * cy]])


def _blur(x, sigma):
    return ndimage.gaussian_filter(x, sigma, mode="mirror")


def _warp_for(motion, h, w):
    """A small warp of the given motion class (inverse-map convention)."""
    if motion == MotionType.Translation:
        m3 = np.eye(3, dtype=np.float32)
        m3[0, 2], m3[1, 2] = 3.25, -2.5
        return m3
    if motion == MotionType.Euclidean:
        rot = _rotation(w / 2.0, h / 2.0, 0.8, 1.0)
    else:
        rot = _rotation(w / 2.0, h / 2.0, 0.8, 1.003)
    rot[0, 2] += 2.25
    rot[1, 2] -= 1.5
    m3 = np.vstack([rot, [0, 0, 1]]).astype(np.float32)
    if motion == MotionType.Homography:
        m3[2, :2] = (2e-5, -1e-5)
    return m3


def _sources(seed, h, w, masked):
    rng = np.random.default_rng(seed)
    img = _blur((rng.random((h, w)) * 255).astype(np.float32), 2.0)
    tmpl = _blur((rng.random((h, w)) * 255).astype(np.float32), 2.0)
    if masked:
        user_mask = np.full((h, w), 255, np.uint8)
        user_mask[h // 3: 2 * h // 3, w // 4: w // 2] = 0
        image_f, gx, gy, pre = ecc_ops._ecc_prepare_input_masked_jit(
            jnp.asarray(img), jnp.asarray(user_mask), 5
        )
        srcs = jnp.stack([image_f, gx, gy, pre])
    else:
        image_f, gx, gy = ecc_ops._ecc_prepare_input_jit(jnp.asarray(img), 5)
        srcs = jnp.stack([image_f, gx, gy])
    return srcs, jnp.asarray(tmpl)[None]


@pytest.mark.parametrize("with_hessian", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("motion", ALL_MOTIONS)
def test_moments_match_xla_fields(motion, masked, with_hessian):
    """The kernel's moment vector equals the one built from the XLA
    fields (ecc_moments_reference), masked or not, with or without the
    Hessian triangle.  97x181 is not a multiple of the kernel's block:
    the ragged last block must stay out of every sum."""
    h, w = 97, 181
    srcs, tmpl = _sources(11, h, w, masked)
    m3 = jnp.asarray(_warp_for(motion, h, w))[None]
    got = np.asarray(ecc_triton.ecc_iteration_moments(
        srcs, tmpl, m3, jnp.ones((1,), bool), motion_type=motion,
        quant_affine=motion != MotionType.Homography,
        with_hessian=with_hessian, interpret=True,
    ))
    full = np.asarray(ecc_triton.ecc_moments_reference(
        srcs, tmpl, m3, motion_type=motion
    ))
    _, n_out = ecc_triton.moments_layout(motion, with_hessian)
    assert got.shape == (1, n_out)
    if not with_hessian:
        # the lazy layout is the full layout without the triangle
        full_got = np.concatenate([got, full[:, n_out:]], axis=1)
    else:
        full_got = got
    stats_err, jac_err = ecc_triton.moments_error(full_got, full, motion)
    # f32 sums in another order; a pixel whose source coordinate sits on
    # a 1/32-px rounding boundary may take the neighbouring tap
    assert stats_err <= 2e-5, stats_err
    assert jac_err <= 1e-4, jac_err


@pytest.mark.parametrize("with_hessian", [True, False])
@pytest.mark.parametrize("n_src", [3, 4])
@pytest.mark.parametrize("motion", ALL_MOTIONS)
def test_kernel_lowers_for_cuda(motion, n_src, with_hessian):
    """Every kernel variant lowers through the Pallas Triton route at
    the north-star size (99 lanes of 2160x3840) — what the card's
    compiler receives; no card is needed to lower."""
    h, w = 2160, 3840
    args = (
        jax.ShapeDtypeStruct((n_src, h, w), jnp.float32),
        jax.ShapeDtypeStruct((99, h, w), jnp.float32),
        jax.ShapeDtypeStruct((99, 3, 3), jnp.float32),
        jax.ShapeDtypeStruct((99,), jnp.bool_),
    )

    def f(s, t, m, a):
        return ecc_triton.ecc_iteration_moments(
            s, t, m, a, motion_type=motion,
            quant_affine=motion != MotionType.Homography,
            with_hessian=with_hessian,
        )

    text = jax.jit(f).trace(*args).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    assert "ecc_iteration_moments" in text


def test_inactive_lanes_write_zero_rows():
    """A lane marked inactive (converged or failed) contributes a zero
    row; the active lanes' rows are unchanged by its presence."""
    h, w = 64, 96
    srcs, tmpl = _sources(12, h, w, False)
    tmpl2 = jnp.concatenate([tmpl, tmpl[:, ::-1]])
    m3 = jnp.asarray(np.stack([_warp_for(MotionType.Affine, h, w)] * 2))
    both = np.asarray(ecc_triton.ecc_iteration_moments(
        srcs, tmpl2, m3, jnp.asarray([True, True]),
        motion_type=MotionType.Affine, quant_affine=True, interpret=True,
    ))
    one = np.asarray(ecc_triton.ecc_iteration_moments(
        srcs, tmpl2, m3, jnp.asarray([True, False]),
        motion_type=MotionType.Affine, quant_affine=True, interpret=True,
    ))
    np.testing.assert_array_equal(one[1], 0.0)
    np.testing.assert_array_equal(one[0], both[0])


def test_kernel_rejects_bad_shapes():
    srcs = jnp.zeros((2, 16, 16), jnp.float32)
    with pytest.raises(ValueError, match="3 or 4 planes"):
        ecc_triton.ecc_iteration_moments(
            srcs, jnp.zeros((1, 16, 16)), jnp.eye(3)[None],
            jnp.ones((1,), bool), motion_type=MotionType.Affine,
        )
    with pytest.raises(ValueError, match="templates"):
        ecc_triton.ecc_iteration_moments(
            jnp.zeros((3, 16, 16)), jnp.zeros((1, 16, 8)),
            jnp.eye(3)[None], jnp.ones((1,), bool),
            motion_type=MotionType.Affine,
        )


def test_round_half_even_matches_jnp_round():
    """The kernel's rounding (floor-based; the Triton lowering has no
    round) is jnp.round's half-to-even on ties, negatives included."""
    v = jnp.asarray(
        [-3.5, -2.5, -1.5, -0.5, -0.49, 0.0, 0.5, 1.5, 2.5, 2.51, 7.25,
         1023.5, -1024.5, 31.999], jnp.float32,
    )
    np.testing.assert_array_equal(
        np.asarray(ecc_triton._round_half_even(v)), np.asarray(jnp.round(v))
    )


def test_unpack_moments_layout():
    """unpack_moments maps the vector layout back to OpenCV's pieces,
    with a symmetric Hessian."""
    p, n_out = ecc_triton.moments_layout(MotionType.Affine, True)
    mom = jnp.arange(2 * n_out, dtype=jnp.float32).reshape(2, n_out)
    (n_raw, s_mi, s_mii, s_mt, s_mtt, s_mti, hess, j_i, j_m,
     j_mt) = ecc_triton.unpack_moments(mom, MotionType.Affine)
    np.testing.assert_array_equal(np.asarray(n_raw), [0, n_out])
    np.testing.assert_array_equal(np.asarray(j_i[0]), np.arange(6, 6 + p))
    np.testing.assert_array_equal(np.asarray(j_mt[0]),
                                  np.arange(6 + 2 * p, 6 + 3 * p))
    h = np.asarray(hess)
    np.testing.assert_array_equal(h, np.transpose(h, (0, 2, 1)))
    assert h[0, 0, 0] == 6 + 3 * p and h[0, 0, 1] == 6 + 3 * p + 1
    assert ecc_triton.unpack_moments(
        mom[:, : 6 + 3 * p], MotionType.Affine, with_hessian=False
    )[6] is None


def test_moments_error_is_scale_relative():
    """moments_error judges a cancelling sum against the size of its
    terms: an absolute error that is small next to sqrt(S(a^2) S(b^2))
    passes even when the sum itself is near zero."""
    p, n_out = ecc_triton.moments_layout(MotionType.Translation, True)
    want = np.zeros((1, n_out))
    want[0, :6] = [100.0, 1e4, 1e6, 1e4, 1e6, 1e6]
    want[0, 6 + 3 * p:] = [1e4, 0.0, 1e4]  # S(jac_p^2), p = 2
    got = want.copy()
    got[0, 6] += 1e-3  # S(jac_0 * i) ~ 0, scale sqrt(1e4 * 1e6) = 1e5
    stats, other = ecc_triton.moments_error(got, want, MotionType.Translation)
    assert stats == 0.0
    assert other == pytest.approx(1e-8)
    with pytest.raises(ValueError):
        ecc_triton.moments_error(got[:, :-1], want[:, :-1],
                                 MotionType.Translation)


def _shifted_pair(seed, h, w, motion):
    rng = np.random.default_rng(seed)
    base = _blur((rng.random((h * 2, w * 2)) * 255).astype(np.float32), 1.5)
    truths = []
    tmpls = []
    for dx, dy, ang in [(2.0, -1.0, 0.4), (-1.75, 1.25, -0.3)]:
        m = _rotation(
            w, h, ang if motion != MotionType.Translation else 0.0, 1.0
        )
        m[0, 2] += dx
        m[1, 2] += dy
        cur = np.asarray(warp.warp_affine(
            jnp.asarray(base), jnp.asarray(m, jnp.float32), inverse_map=True,
        ))
        tmpls.append(cur[h // 2: h // 2 + h, w // 2: w // 2 + w])
        off = np.array([[1, 0, w // 2], [0, 1, h // 2], [0, 0, 1]])
        m3 = np.vstack([m, [0, 0, 1]])
        truths.append(np.linalg.inv(off) @ m3 @ off)
    ref = base[h // 2: h // 2 + h, w // 2: w // 2 + w]
    return (jnp.asarray(np.stack(tmpls).astype(np.uint8), jnp.float32),
            jnp.asarray(ref.astype(np.uint8), jnp.float32),
            np.stack(truths))


@pytest.mark.parametrize("motion", ALL_MOTIONS)
def test_fused_solve_matches_xla(ecc_kernel_interpret, motion):
    """find_transform_ecc_batched driven through the kernel (interpret
    mode) recovers the true warps and lands where the XLA path lands.
    The trajectories differ legitimately (f32 order, 1/32-px rounding
    flips), so the assertion is solution quality, not bitwise state."""
    h, w = 96, 200
    templates, ref, truth = _shifted_pair(5, h, w, motion)
    kw = dict(num_iters=50, eps=1e-5, gauss_filt_size=5)
    with ecc_kernel_interpret.off():
        res_xla = ecc_ops.find_transform_ecc_batched(
            templates, ref, motion, **kw
        )
    res_k = ecc_ops.find_transform_ecc_batched(templates, ref, motion, **kw)
    assert np.asarray(res_k.ok).all()
    wk = np.asarray(res_k.warp_matrix)
    rows = 3 if motion == MotionType.Homography else 2
    np.testing.assert_allclose(wk[:, :2, 2], truth[:, :2, 2], atol=0.1)
    np.testing.assert_allclose(
        wk, np.asarray(res_xla.warp_matrix)[:, :rows], atol=0.03
    )
    np.testing.assert_allclose(
        np.asarray(res_k.rho), np.asarray(res_xla.rho), atol=1e-3
    )


@pytest.mark.parametrize("motion", ALL_MOTIONS)
def test_lazy_solve_recovers_truth_all_motions(ecc_kernel_interpret, motion):
    """mode='lazy' (Gram carried from each lane's first iteration)
    recovers the true shifts across motion models and converges to
    the forward solve's correlation."""
    h, w = 96, 200
    templates, ref, truth = _shifted_pair(7, h, w, motion)
    kw = dict(num_iters=50, eps=1e-5, gauss_filt_size=5)
    res_f = ecc_ops.find_transform_ecc_batched(templates, ref, motion, **kw)
    res_l = ecc_ops.find_transform_ecc_batched(
        templates, ref, motion, mode="lazy", **kw
    )
    assert np.asarray(res_l.ok).all()
    np.testing.assert_allclose(
        np.asarray(res_l.warp_matrix)[:, :2, 2], truth[:, :2, 2], atol=0.1
    )
    np.testing.assert_allclose(
        np.asarray(res_l.rho), np.asarray(res_f.rho), atol=2e-3
    )


def test_failure_verdict_matches_xla(ecc_kernel_interpret):
    """A lane OpenCV fails on (a featureless template: zero variance ->
    NaN correlation) fails identically through the kernel, with no
    fallback to the XLA path; the healthy lane beside it converges."""
    h, w = 96, 200
    templates, ref, _ = _shifted_pair(9, h, w, MotionType.Translation)
    templates = templates.at[1].set(128.0)
    kw = dict(num_iters=30, eps=1e-5, gauss_filt_size=5)
    with ecc_kernel_interpret.off():
        res_xla = ecc_ops.find_transform_ecc_batched(
            templates, ref, MotionType.Translation, **kw
        )
    res_k = ecc_ops.find_transform_ecc_batched(
        templates, ref, MotionType.Translation, **kw
    )
    np.testing.assert_array_equal(
        np.asarray(res_k.ok), np.asarray(res_xla.ok)
    )
    assert list(np.asarray(res_k.ok)) == [True, False]
    assert float(np.asarray(res_k.rho)[1]) == -1.0


def test_kernel_chosen_on_gpu_for_large_images(monkeypatch):
    """The kernel is chosen from the input alone: a GPU backend and an
    image of at least one kernel program's pixels."""
    big = ecc_triton.PIXELS_PER_PROGRAM
    assert not ecc_ops._kernel_ok(1080, 1920)  # the test backend: CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert ecc_ops._kernel_ok(2160, 3840)
    assert ecc_ops._kernel_ok(1, big)
    assert not ecc_ops._kernel_ok(1, big - 1)


def test_template_smaller_than_input_uses_xla(ecc_kernel_interpret):
    """A template smaller than the input image (supported by
    cv2.findTransformECC and the XLA branch) takes the XLA path even
    where the kernel is chosen — the kernel needs one extent."""
    rng = np.random.default_rng(42)
    hs, ws = 120, 200
    ht, wt = 96, 160
    base = _blur((rng.random((hs, ws)) * 255).astype(np.float32), 2.0)
    x0, y0 = 3, 2
    tmpl = base[y0: y0 + ht, x0: x0 + wt].copy()
    res = ecc_ops.find_transform_ecc_batched(
        jnp.asarray(tmpl)[None], jnp.asarray(base),
        MotionType.Translation, num_iters=60, eps=1e-5, gauss_filt_size=5,
    )
    assert bool(np.asarray(res.ok)[0])
    np.testing.assert_allclose(
        np.asarray(res.warp_matrix)[0, :2, 2], [x0, y0], atol=0.1
    )


def test_mode_ic_raises(monkeypatch):
    """The inverse-compositional mode is gone: asking for it by
    argument or by LIBSTACKER_ECC_MODE raises InvalidParamsError."""
    t = jnp.zeros((1, 32, 32))
    with pytest.raises(InvalidParamsError, match="inverse-compositional"):
        ecc_ops.find_transform_ecc_batched(t, t[0], mode="ic")
    monkeypatch.setenv("LIBSTACKER_ECC_MODE", "ic")
    with pytest.raises(InvalidParamsError, match="inverse-compositional"):
        ecc_ops.find_transform_ecc_batched_graph(t, t[0])
    monkeypatch.setenv("LIBSTACKER_ECC_MODE", "banana")
    with pytest.raises(InvalidParamsError, match="forward"):
        ecc_ops._ecc_mode_default()


@pytest.mark.gpu
def test_kernel_on_gpu_matches_reference(gpu):
    """On a card: the compiled kernel's moments at 1080p against the
    XLA fields, masked and not (tolerances as in
    test_moments_match_xla_fields)."""
    h, w = 1080, 1920
    for motion in (MotionType.Affine, MotionType.Homography):
        for masked in (False, True):
            srcs, tmpl = _sources(13, h, w, masked)
            m3 = jnp.asarray(_warp_for(motion, h, w))[None]
            got = ecc_triton.ecc_iteration_moments(
                srcs, tmpl, m3, jnp.ones((1,), bool), motion_type=motion,
                quant_affine=motion != MotionType.Homography,
            )
            want = ecc_triton.ecc_moments_reference(
                srcs, tmpl, m3, motion_type=motion
            )
            stats_err, jac_err = ecc_triton.moments_error(got, want, motion)
            assert stats_err <= 2e-5 and jac_err <= 1e-4

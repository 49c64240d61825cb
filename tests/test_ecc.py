"""ECC engine parity vs cv2.findTransformECC (SURVEY.md N9-N11).

Small synthetic frames keep single-core CPU runtime sane; per-motion
parity is asserted on the estimated warp matrices after a fixed
iteration budget and after epsilon-convergence.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from libstacker_tpu.ops import ecc as ecc_ops
from libstacker_tpu.params import MotionType

_CV_MOTION = {
    MotionType.Translation: cv2.MOTION_TRANSLATION,
    MotionType.Euclidean: cv2.MOTION_EUCLIDEAN,
    MotionType.Affine: cv2.MOTION_AFFINE,
    MotionType.Homography: cv2.MOTION_HOMOGRAPHY,
}


def _make_pair(kind, h=80, w=100, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.random((h * 2, w * 2)).astype(np.float32)
    base = cv2.GaussianBlur(base, (0, 0), 3.0) * 255.0
    ref = base[h // 2 : h // 2 + h, w // 2 : w // 2 + w].copy()
    if kind == MotionType.Translation:
        m = np.array([[1, 0, 2.3], [0, 1, -1.7]], np.float32)
    elif kind == MotionType.Euclidean:
        m = cv2.getRotationMatrix2D((w / 2, h / 2), 1.2, 1.0).astype(np.float32)
        m[0, 2] += 1.1
    elif kind == MotionType.Affine:
        m = np.array([[1.008, 0.01, 1.2], [-0.006, 0.996, -0.7]], np.float32)
    else:
        m = np.array(
            [[1.008, 0.008, 1.2], [-0.006, 0.998, -0.7], [1.5e-5, -8e-6, 1.0]],
            np.float32,
        )
    flags = cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP
    if m.shape[0] == 2:
        cur = cv2.warpAffine(base, m, (w * 2, h * 2), flags=flags)
    else:
        cur = cv2.warpPerspective(base, m, (w * 2, h * 2), flags=flags)
    cur = cur[h // 2 : h // 2 + h, w // 2 : w // 2 + w].copy()
    return ref.astype(np.uint8), cur.astype(np.uint8)


def _run_cv(cur, ref, motion, iters, eps):
    typ = 0
    if iters is not None:
        typ |= cv2.TERM_CRITERIA_COUNT
    if eps is not None:
        typ |= cv2.TERM_CRITERIA_EPS
    crit = (typ, iters or 0, eps or 0.0)
    wm = (
        np.eye(3, dtype=np.float32)
        if motion == MotionType.Homography
        else np.eye(2, 3, dtype=np.float32)
    )
    return cv2.findTransformECC(cur, ref, wm, _CV_MOTION[motion], crit, None, 5)


@pytest.mark.parametrize(
    "motion",
    [MotionType.Translation, MotionType.Euclidean, MotionType.Affine,
     MotionType.Homography],
)
def test_ecc_matches_cv2_fixed_iters(motion):
    ref, cur = _make_pair(motion)
    rho_cv, m_cv = _run_cv(cur, ref, motion, 30, None)
    res = ecc_ops.find_transform_ecc(
        jnp.asarray(cur), jnp.asarray(ref), motion_type=motion,
        num_iters=30, eps=-1.0, gauss_filt_size=5,
    )
    assert bool(res.ok)
    m_us = np.asarray(res.warp_matrix)
    # translation components within a few hundredths of a pixel,
    # linear components within 1e-3
    np.testing.assert_allclose(m_us[:, 2], m_cv[:, 2], atol=5e-2)
    np.testing.assert_allclose(m_us[:, :2], m_cv[:, :2], atol=2e-3)
    # rho is a diagnostic; small f32/warp-quantisation drift accumulates
    assert float(res.rho) == pytest.approx(rho_cv, abs=2e-2)


def test_ecc_translation_converges_to_truth():
    ref, cur = _make_pair(MotionType.Translation)
    res = ecc_ops.find_transform_ecc(
        jnp.asarray(cur), jnp.asarray(ref),
        motion_type=MotionType.Translation,
        num_iters=100, eps=1e-6, gauss_filt_size=5,
    )
    m = np.asarray(res.warp_matrix)
    # the synthetic shift is (2.3, -1.7)
    np.testing.assert_allclose(m[0, 2], 2.3, atol=0.15)
    np.testing.assert_allclose(m[1, 2], -1.7, atol=0.15)


def test_ecc_batched_matches_single():
    ref, cur1 = _make_pair(MotionType.Affine, seed=3)
    _, cur2 = _make_pair(MotionType.Affine, seed=3)
    batch = jnp.stack([jnp.asarray(cur1), jnp.asarray(cur2)])
    res_b = ecc_ops.find_transform_ecc_batched(
        batch, jnp.asarray(ref), motion_type=MotionType.Affine,
        num_iters=20, eps=-1.0, gauss_filt_size=5,
    )
    res_s = ecc_ops.find_transform_ecc(
        jnp.asarray(cur1), jnp.asarray(ref), motion_type=MotionType.Affine,
        num_iters=20, eps=-1.0, gauss_filt_size=5,
    )
    # batched path reduces with einsum, single path with matmul: f32
    # reduction-order noise compounds over the 20 forced (eps=-1)
    # iterations — this is a trajectory-noise bound, not an accuracy
    # bound (cv2-oracle parity is asserted by the other tests here)
    np.testing.assert_allclose(
        np.asarray(res_b.warp_matrix[0]), np.asarray(res_s.warp_matrix),
        atol=5e-3,
    )
    np.testing.assert_allclose(
        np.asarray(res_b.warp_matrix[0]), np.asarray(res_b.warp_matrix[1]),
        atol=1e-6,
    )


def test_ecc_lane_chunking(monkeypatch):
    """Bursts beyond the memory-derived lane-group size
    (ops.ecc._lanes_per_group) split into host-level lane groups;
    results must equal the unchunked solve."""
    ref, cur1 = _make_pair(MotionType.Translation, seed=5)
    batch = jnp.stack([jnp.asarray(cur1)] * 6)
    full = ecc_ops.find_transform_ecc_batched(
        batch, jnp.asarray(ref), motion_type=MotionType.Translation,
        num_iters=20, eps=1e-4, gauss_filt_size=5,
    )
    monkeypatch.setattr(ecc_ops, "_lanes_per_group", lambda h, w, k: 4)
    chunked = ecc_ops.find_transform_ecc_batched(
        batch, jnp.asarray(ref), motion_type=MotionType.Translation,
        num_iters=20, eps=1e-4, gauss_filt_size=5,
    )
    assert np.asarray(chunked.ok).all()
    np.testing.assert_allclose(
        np.asarray(chunked.warp_matrix), np.asarray(full.warp_matrix),
        atol=1e-6,
    )


def test_ecc_epsilon_early_stop():
    ref, cur = _make_pair(MotionType.Translation)
    res = ecc_ops.find_transform_ecc(
        jnp.asarray(cur), jnp.asarray(ref),
        motion_type=MotionType.Translation,
        num_iters=200, eps=1e-4, gauss_filt_size=5,
    )
    assert int(res.num_iters) < 200
    assert bool(res.ok)


def test_ecc_multiscale_matches_single_scale():
    ref, cur = _make_pair(MotionType.Homography, h=160, w=200)
    import jax.numpy as jnp

    r1 = ecc_ops.find_transform_ecc_batched(
        jnp.asarray(cur)[None], jnp.asarray(ref),
        motion_type=MotionType.Homography, num_iters=100, eps=1e-5,
        gauss_filt_size=5,
    )
    r2 = ecc_ops.find_transform_ecc_batched(
        jnp.asarray(cur)[None], jnp.asarray(ref),
        motion_type=MotionType.Homography, num_iters=100, eps=1e-5,
        gauss_filt_size=5, coarse_levels=1,
    )
    assert bool(r2.ok[0])
    # coarse init converges to the same warp (eps stopping points differ
    # slightly on small noisy frames: translations within a tenth-pixel,
    # linear parts tight), in no more full-res iterations
    m1 = np.asarray(r1.warp_matrix[0])
    m2 = np.asarray(r2.warp_matrix[0])
    np.testing.assert_allclose(m2[:2, :2], m1[:2, :2], atol=5e-3)
    np.testing.assert_allclose(m2[:2, 2], m1[:2, 2], atol=0.15)
    np.testing.assert_allclose(m2[2, :2], m1[2, :2], atol=2e-4)
    assert int(r2.num_iters[0]) <= int(r1.num_iters[0])


def test_ecc_coarse_levels_scales_warp_init():
    """Regression: a full-resolution ``warp_init`` (the phase-correlation
    warm start's frame) must be rescaled into the coarsest solved
    octave's grid.  With the unscaled bug a truth-exact init lands
    2^levels too far out at the coarse level; under a tight iteration
    budget the solve cannot recover and the final translation is off."""
    rng = np.random.default_rng(11)
    h, w = 256, 320
    base = cv2.GaussianBlur(
        rng.random((h * 2, w * 2)).astype(np.float32), (0, 0), 3.0
    ) * 255.0
    ref = base[h // 2 : h // 2 + h, w // 2 : w // 2 + w].copy()
    dx, dy = 8.4, -5.0
    m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
    cur = cv2.warpAffine(
        base, m, (w * 2, h * 2), flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP
    )[h // 2 : h // 2 + h, w // 2 : w // 2 + w].copy()
    init = jnp.asarray(
        np.array([[1, 0, dx], [0, 1, dy]], np.float32)
    )[None]
    res = ecc_ops.find_transform_ecc_batched(
        jnp.asarray(cur.astype(np.uint8))[None],
        jnp.asarray(ref.astype(np.uint8)),
        motion_type=MotionType.Translation,
        num_iters=2, eps=-1.0, gauss_filt_size=5,
        coarse_levels=2, warp_init=init,
    )
    got = np.asarray(res.warp_matrix[0])
    # truth-exact init + correctly-scaled octaves: 2 iterations per
    # level only polish; the buggy unscaled init starts the coarse
    # octave 3/4 * 2.35px off (in quarter-res pixels) and a 2-iteration
    # budget leaves >0.5px of error at full resolution
    np.testing.assert_allclose(got[0, 2], dx, atol=0.2)
    np.testing.assert_allclose(got[1, 2], dy, atol=0.2)


def test_octave_box_mean_matches_inter_area():
    """The coarse-to-fine octave builder's exact-2x fast path (one
    reshape-mean) must match INTER_AREA: for an integer 2x reduction
    INTER_AREA's fractional-span weights are exactly uniform 1/4, so
    the two formulations agree to f32 rounding; odd extents take the
    banded path and stay bit-faithful to cv2."""
    rng = np.random.default_rng(5)
    for h, w in [(64, 128), (62, 130), (63, 129)]:
        x = (rng.random((2, h, w)) * 255).astype(np.float32)
        got = np.asarray(ecc_ops._resize_area_jit(
            jnp.asarray(x), h // 2, w // 2
        ))
        ref = np.stack([
            cv2.resize(f, (w // 2, h // 2), interpolation=cv2.INTER_AREA)
            for f in x
        ])
        np.testing.assert_allclose(got, ref, atol=2e-4)


def test_rho_init_cross_scale_seed_stops_after_one_iteration():
    """rho_init (the coarse-to-fine cross-scale seed) applies OpenCV's
    |d rho| < eps stopping rule across solves: re-solving from an
    already-converged warp with its rho seeded stops after ONE
    polishing iteration, while the unseeded cold start pays at least
    two; the solution itself is unchanged."""
    import jax.numpy as jnp

    ref, cur = _make_pair(MotionType.Translation, h=160, w=200)
    t = jnp.asarray(cur)[None]
    i = jnp.asarray(ref)
    kw = dict(
        motion_type=MotionType.Translation, num_iters=100, eps=1e-4,
        gauss_filt_size=5,
    )
    base = ecc_ops.find_transform_ecc_batched(t, i, **kw)
    assert bool(base.ok[0])

    seeded = ecc_ops.find_transform_ecc_batched(
        t, i, warp_init=base.warp_matrix, rho_init=base.rho, **kw
    )
    cold = ecc_ops.find_transform_ecc_batched(
        t, i, warp_init=base.warp_matrix, **kw
    )
    assert bool(seeded.ok[0]) and bool(cold.ok[0])
    # the seed's rho is measured at the same warp and scale, so the
    # first iteration's |d rho| is ~0 and the lane stops there
    assert int(seeded.num_iters[0]) == 1
    assert int(cold.num_iters[0]) >= 2
    # iterates past a converged point wander by ~0.02px on this
    # double-resampled synthetic content (multi-modal rho landscape,
    # CLAUDE.md) — both stops are valid eps stopping points, so assert
    # solution closeness, not bitwise iterate equality
    np.testing.assert_allclose(
        np.asarray(seeded.warp_matrix), np.asarray(cold.warp_matrix),
        atol=0.05,
    )
    np.testing.assert_allclose(
        np.asarray(seeded.warp_matrix), np.asarray(base.warp_matrix),
        atol=0.05,
    )
    # invalid seeds (-1) keep the cold start
    unseeded = ecc_ops.find_transform_ecc_batched(
        t, i, warp_init=base.warp_matrix,
        rho_init=jnp.full((1,), -1.0, jnp.float32), **kw
    )
    assert int(unseeded.num_iters[0]) == int(cold.num_iters[0])


def test_solve_octave_nosync_empty_lane_set():
    """Regression: the octave solves of a coarse-to-fine solve must keep
    the main entry's n==0 guard — a 1-frame burst's frames[1:] with
    coarse_levels>0 once hit jnp.concatenate([])."""
    for mt, r in [(MotionType.Translation, 2), (MotionType.Homography, 3)]:
        res = ecc_ops.find_transform_ecc_batched(
            jnp.zeros((0, 160, 384), jnp.float32),
            jnp.zeros((160, 384), jnp.float32),
            mt, 10, 1e-4, 5, coarse_levels=1,
        )
        assert res.warp_matrix.shape == (0, r, 3)
        assert res.rho.shape == (0,) and res.ok.shape == (0,)


def test_coarse_rho_seed_cross_scale_accuracy(monkeypatch):
    """The DEFAULT cross-scale rho seed (a coarse octave's converged rho
    handed to the full-res solve's |d rho| < eps test) must not trade
    accuracy for the saved confirm sweep: on content with known ground
    truth, the seeded coarse-to-fine solve must land as close to the
    true warp as the unseeded one (r3 advisor: the seed compares rho
    values measured on DIFFERENT content, so a coincidental first-
    iteration match could stop an unconverged lane)."""
    rng = np.random.default_rng(23)
    h, w = 256, 320
    base = cv2.GaussianBlur(
        rng.random((h * 2, w * 2)).astype(np.float32), (0, 0), 3.0
    ) * 255.0
    ref = base[h // 2 : h // 2 + h, w // 2 : w // 2 + w].copy()
    truths, curs = [], []
    for dx, dy in [(6.4, -3.0), (-4.2, 5.5), (0.6, 0.2)]:
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        curs.append(cv2.warpAffine(
            base, m, (w * 2, h * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )[h // 2 : h // 2 + h, w // 2 : w // 2 + w].copy())
        truths.append((dx, dy))
    t = jnp.asarray(np.stack(curs).astype(np.uint8))
    i = jnp.asarray(ref.astype(np.uint8))
    kw = dict(
        motion_type=MotionType.Translation, num_iters=100, eps=1e-4,
        gauss_filt_size=5, coarse_levels=1,
    )
    monkeypatch.delenv("LIBSTACKER_COARSE_RHO_SEED", raising=False)
    seeded = ecc_ops.find_transform_ecc_batched(t, i, **kw)
    monkeypatch.setenv("LIBSTACKER_COARSE_RHO_SEED", "0")
    unseeded = ecc_ops.find_transform_ecc_batched(t, i, **kw)
    assert np.asarray(seeded.ok).all() and np.asarray(unseeded.ok).all()
    got_s = np.asarray(seeded.warp_matrix)
    got_u = np.asarray(unseeded.warp_matrix)
    for k, (dx, dy) in enumerate(truths):
        err_s = float(np.hypot(got_s[k, 0, 2] - dx, got_s[k, 1, 2] - dy))
        err_u = float(np.hypot(got_u[k, 0, 2] - dx, got_u[k, 1, 2] - dy))
        # both are valid eps stopping points on this bilinear-resampled
        # content (multi-modal rho landscape, CLAUDE.md): the seed may
        # move the stopping point but must stay in the same basin
        assert err_s < 0.25, (k, err_s)
        assert err_s <= err_u + 0.1, (k, err_s, err_u)

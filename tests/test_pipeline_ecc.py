"""End-to-end ``ecc_match`` parity vs an OpenCV oracle pipeline
(SURVEY.md §7 phase 4 milestone; oracle mirrors ref src/lib.rs:719-847)."""

import cv2
import numpy as np
import pytest

from libstacker_tpu import EccMatchParameters, MotionType, ecc_match_arrays
from libstacker_tpu.errors import InvalidParamsError
from libstacker_tpu.utils import io


def _make_burst(rng, n=4, h=80, w=100):
    base = rng.random((h * 2, w * 2)).astype(np.float32)
    base = cv2.GaussianBlur(base, (0, 0), 3.0)
    base = (base - base.min()) / (base.max() - base.min())
    base_u8 = (base * 255).astype(np.uint8)
    frames = []
    shifts = [(0.0, 0.0)] + [tuple(rng.uniform(-3, 3, 2)) for _ in range(n - 1)]
    for dx, dy in shifts:
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(
            base_u8, m, (w * 2, h * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )
        crop = cur[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([crop] * 3, axis=-1))
    return np.stack(frames)


def _oracle_ecc_stack(frames, motion, criteria, gauss):
    """The reference pipeline recomputed with cv2 (src/lib.rs:719-847):
    template = current grey, input = frame0 grey; warp applied forward;
    divide by total frame count."""
    greys = [io.rgb_to_gray_u8_host(f) for f in frames]
    f32s = [f.astype(np.float32) / 255.0 for f in frames]
    h, w = greys[0].shape
    acc = f32s[0].copy()
    for i in range(1, len(frames)):
        wm = (
            np.eye(3, dtype=np.float32)
            if motion == cv2.MOTION_HOMOGRAPHY
            else np.eye(2, 3, dtype=np.float32)
        )
        cv2.findTransformECC(greys[i], greys[0], wm, motion, criteria, None, gauss)
        if motion == cv2.MOTION_HOMOGRAPHY:
            warped = cv2.warpPerspective(f32s[i], wm, (w, h))
        else:
            warped = cv2.warpAffine(f32s[i], wm, (w, h))
        acc += warped
    return acc / len(frames)


@pytest.mark.parametrize(
    "motion,cv_motion",
    [
        (MotionType.Translation, cv2.MOTION_TRANSLATION),
        (MotionType.Euclidean, cv2.MOTION_EUCLIDEAN),
        (MotionType.Affine, cv2.MOTION_AFFINE),
        (MotionType.Homography, cv2.MOTION_HOMOGRAPHY),
    ],
)
def test_ecc_match_matches_oracle(rng, motion, cv_motion):
    frames = _make_burst(rng)
    params = EccMatchParameters(
        motion_type=motion, max_count=50, epsilon=1e-4, gauss_filt_size=5
    )
    got = ecc_match_arrays(frames, params)
    crit = (cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 50, 1e-4)
    expected = _oracle_ecc_stack(frames, cv_motion, crit, 5)
    # interior comparison (borders differ by constant-fill of shifted frames)
    assert got.shape == expected.shape
    diff = np.abs(got[8:-8, 8:-8] - expected[8:-8, 8:-8])
    assert diff.max() < 0.02, f"max diff {diff.max()}"


def test_ecc_match_scaled(rng):
    frames = _make_burst(rng, h=100, w=140)
    params = EccMatchParameters(
        motion_type=MotionType.Translation, max_count=50, epsilon=1e-4,
        gauss_filt_size=5,
    )
    got = ecc_match_arrays(frames, params, scale_down_width=64.0)
    full = ecc_match_arrays(frames, params)
    diff = np.abs(got[10:-10, 10:-10] - full[10:-10, 10:-10])
    assert diff.max() < 0.05


def test_ecc_match_ic_solver(monkeypatch):
    """The inverse-compositional solver was removed: solver='ic' and
    LIBSTACKER_ECC_MODE=ic raise InvalidParamsError before any work."""
    from libstacker_tpu.errors import InvalidParamsError

    frames = np.zeros((2, 32, 48, 3), np.uint8)
    params_ic = EccMatchParameters(
        motion_type=MotionType.Translation, max_count=5, epsilon=1e-4,
        solver="ic",
    )
    with pytest.raises(InvalidParamsError, match="inverse-compositional"):
        ecc_match_arrays(frames, params_ic)
    monkeypatch.setenv("LIBSTACKER_ECC_MODE", "ic")
    params = EccMatchParameters(
        motion_type=MotionType.Translation, max_count=5, epsilon=1e-4,
    )
    with pytest.raises(InvalidParamsError, match="inverse-compositional"):
        ecc_match_arrays(frames, params)


def test_ecc_match_lazy_solver(ecc_kernel_interpret):
    """solver='lazy' through the fused kernel (interpret mode) produces
    the same stack as the forward solver on the XLA path — the
    params -> driver -> kernel plumbing of the lazy-Hessian mode."""
    rng = np.random.default_rng(71)  # local rng: the session fixture's
    # draws are order-dependent (see tests/conftest.py note)
    frames = _make_burst(rng, n=3, h=192, w=512)
    params_fwd = EccMatchParameters(
        motion_type=MotionType.Translation, max_count=50, epsilon=1e-4,
        gauss_filt_size=5,
    )
    with ecc_kernel_interpret.off():
        want = ecc_match_arrays(frames, params_fwd)
    params_lazy = EccMatchParameters(
        motion_type=MotionType.Translation, max_count=50, epsilon=1e-4,
        gauss_filt_size=5, solver="lazy",
    )
    got = ecc_match_arrays(frames, params_lazy)
    diff = np.abs(got[8:-8, 8:-8] - want[8:-8, 8:-8])
    assert diff.max() < 0.02, f"max diff {diff.max()}"


def test_ecc_match_phase_init_rotation_plumbing():
    """phase_init_rotation=True routes through the pipeline and yields
    the same stack as the default init on a rotating burst (the
    rotation-aware warm start only moves the solve's starting point)."""
    rng = np.random.default_rng(97)  # local rng (session stream note)
    h, w = 192, 256
    base = cv2.GaussianBlur(
        (rng.random((h * 2, w * 2)) * 255).astype(np.float32), (0, 0), 2.0
    )
    frames = []
    for ang in (0.0, 0.5, -0.4):
        m = cv2.getRotationMatrix2D((w, h), ang, 1.0)
        cur = cv2.warpAffine(
            base, m, (w * 2, h * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )
        c = np.clip(
            cur[h // 2 : h // 2 + h, w // 2 : w // 2 + w], 0, 255
        ).astype(np.uint8)
        frames.append(np.stack([c] * 3, -1))
    frames = np.stack(frames)
    kw = dict(motion_type=MotionType.Euclidean, max_count=60, epsilon=1e-4)
    out_rot = ecc_match_arrays(
        frames, EccMatchParameters(phase_init_rotation=True, **kw)
    )
    out_def = ecc_match_arrays(frames, EccMatchParameters(**kw))
    d = np.abs(out_rot[8:-8, 8:-8] - out_def[8:-8, 8:-8]).max()
    assert d < 0.02, d


def test_ecc_params_solver_validated():
    params = EccMatchParameters(
        motion_type=MotionType.Translation, solver="banana"
    )
    with pytest.raises(InvalidParamsError, match="solver"):
        params.validate()


def test_ecc_params_coarse_levels_validated():
    for bad in (-1, 6, 1.5, "2"):
        params = EccMatchParameters(
            motion_type=MotionType.Translation, coarse_levels=bad
        )
        with pytest.raises(InvalidParamsError, match="coarse_levels"):
            params.validate()


def test_ecc_match_coarse_levels_plumbing():
    """coarse_levels routes through the pipeline and yields the same
    stack as the direct full-resolution solve (the octaves only move
    the solve's starting point; the full-res iterations converge to
    the same warp)."""
    rng = np.random.default_rng(43)  # local rng (session stream note)
    h, w = 160, 200
    frames = _make_burst(rng, n=3, h=h, w=w)
    kw = dict(motion_type=MotionType.Translation, max_count=80,
              epsilon=1e-5)
    out_coarse, stats = ecc_match_arrays(
        frames, EccMatchParameters(coarse_levels=1, **kw),
        return_stats=True,
    )
    out_def = ecc_match_arrays(frames, EccMatchParameters(**kw))
    assert stats.frames_kept == 3
    d = np.abs(out_coarse[8:-8, 8:-8] - out_def[8:-8, 8:-8]).max()
    assert d < 0.02, d


def test_ecc_match_scale_guards(rng):
    frames = _make_burst(rng)
    params = EccMatchParameters(motion_type=MotionType.Translation)
    with pytest.raises(InvalidParamsError):
        ecc_match_arrays(frames, params, scale_down_width=100.0)  # >= width
    with pytest.raises(InvalidParamsError):
        ecc_match_arrays(frames, params, scale_down_width=10.0)  # too small


def test_ecc_match_single_frame(rng):
    """A 1-file input returns stacked/1 = frame 0, like the reference's
    sum/total at src/lib.rs:836-843 (regression: used to crash on the
    empty frames[1:] lane set)."""
    frames = _make_burst(rng, n=1)
    params = EccMatchParameters(
        motion_type=MotionType.Homography, max_count=50, epsilon=1e-4,
        gauss_filt_size=5,
    )
    out = ecc_match_arrays(frames, params)
    np.testing.assert_allclose(
        out, frames[0].astype(np.float32) / 255.0, atol=1e-7
    )
    out2, stats = ecc_match_arrays(frames, params, return_stats=True)
    assert stats.frames_total == 1 and stats.frames_kept == 1
    # scale guards still apply to 1-frame bursts
    with pytest.raises(InvalidParamsError):
        ecc_match_arrays(frames, params, scale_down_width=100.0)


def test_ecc_match_stats(rng):
    frames = _make_burst(rng)
    params = EccMatchParameters(
        motion_type=MotionType.Translation, max_count=50, epsilon=1e-4,
        gauss_filt_size=5,
    )
    out, stats = ecc_match_arrays(frames, params, return_stats=True)
    assert stats.frames_total == 4
    assert stats.frames_kept == 4
    assert len(stats.ecc_iterations) == 3
    assert all(r > 0.9 for r in stats.ecc_rho)


def test_prelude_surface():
    from libstacker_tpu import prelude

    assert prelude.RANSAC == 8
    assert callable(prelude.keypoint_match)
    assert callable(prelude.ecc_match)
    assert prelude.MotionType.Homography == 3


def test_ecc_match_stream_matches_batch(rng, tmp_path):
    from PIL import Image

    from libstacker_tpu.models.ecc import ecc_match_stream

    frames = _make_burst(rng, n=5)
    files = []
    for i, f in enumerate(frames):
        p = tmp_path / f"f{i}.png"
        Image.fromarray(f).save(p)
        files.append(p)
    params = EccMatchParameters(
        motion_type=MotionType.Translation, max_count=50, epsilon=1e-4,
        gauss_filt_size=5,
    )
    batch = ecc_match_arrays(frames, params)
    streamed = ecc_match_stream(files, params, chunk_size=2)
    np.testing.assert_allclose(streamed, batch, atol=1e-5)


def test_device_resident_input_and_output():
    """jax.Array bursts are used in place (no forced np.asarray
    download) and device_output=True returns the stack still in HBM —
    both bitwise-identical to the numpy round-trip."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(71)
    h, w = 64, 96
    base = cv2.GaussianBlur(
        rng.random((h * 2, w * 2)).astype(np.float32), (0, 0), 3.0
    ) * 255.0
    frames = []
    for dx, dy in [(0, 0), (2.0, -1.0), (-1.5, 2.5)]:
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(
            base, m, (w * 2, h * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([cur] * 3, -1).astype(np.uint8))
    frames = np.stack(frames)
    params = EccMatchParameters(
        motion_type=MotionType.Translation, max_count=30, epsilon=1e-4
    )
    want = ecc_match_arrays(frames, params)
    got_dev = ecc_match_arrays(jnp.asarray(frames), params)
    np.testing.assert_array_equal(np.asarray(got_dev), want)
    out_dev = ecc_match_arrays(frames, params, device_output=True)
    assert isinstance(out_dev, jax.Array)
    np.testing.assert_array_equal(np.asarray(out_dev), want)
    # keypoint counterpart
    from libstacker_tpu import KeyPointMatchParameters, keypoint_match_arrays

    tex = np.stack([np.roll(
        rng.integers(0, 256, (96 // 8, 128 // 8), np.uint8)
        .repeat(8, 0).repeat(8, 1), i, 1) for i in range(3)])
    kframes = np.repeat(tex[..., None], 3, axis=-1)
    d0, w0 = keypoint_match_arrays(kframes, KeyPointMatchParameters())
    d1, w1 = keypoint_match_arrays(
        jnp.asarray(kframes), KeyPointMatchParameters(),
        device_output=True,
    )
    assert d0 == d1
    assert isinstance(w1, jax.Array)
    np.testing.assert_array_equal(np.asarray(w1), w0)

"""Batched stage-3 warps (ops/warp_batch.py) against OpenCV and the
per-frame warps: every border mode, perspective and affine coordinate
quantisation, non-aligned sizes, large motion, dropped lanes and raw
integer sources."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from libstacker_tpu import constants
from libstacker_tpu.ops import color, warp_batch

BORDERS = [
    ("constant", cv2.BORDER_CONSTANT),
    ("replicate", cv2.BORDER_REPLICATE),
    ("reflect", cv2.BORDER_REFLECT),
    ("reflect101", cv2.BORDER_REFLECT_101),
    ("wrap", cv2.BORDER_WRAP),
    ("transparent", cv2.BORDER_TRANSPARENT),
]


def _assert_warp_close(got, expected, tight=5e-3, loose=0.06, frac=0.01):
    """Parity modulo f32-vs-f64 1/32-bin rounding flips: almost all
    pixels match tightly; a flip moves a pixel by one interpolation
    step of the local range."""
    diff = np.abs(np.asarray(got) - np.asarray(expected))
    assert (diff > tight).mean() < frac, (diff > tight).mean()
    assert diff.max() < loose, diff.max()


@pytest.fixture(scope="module")
def burst():
    rng = np.random.default_rng(77)  # local: see conftest rng note
    h, w = 97, 131
    frames = np.stack([
        cv2.GaussianBlur(rng.random((h, w, 3)).astype(np.float32),
                         (0, 0), 1.5)
        for _ in range(4)
    ])
    mats = []
    for i in range(4):
        m = cv2.getRotationMatrix2D((w / 2, h / 2), 2.0 * i, 1.0 + 0.01 * i)
        m[0, 2] += 3.25 * i
        m[1, 2] -= 1.5 * i
        m3 = np.vstack([m, [0, 0, 1]])
        m3[2, :2] = (1e-4 * i, -5e-5 * i)
        mats.append(m3.astype(np.float32))
    return frames, np.stack(mats)


@pytest.mark.parametrize("perspective", [True, False])
@pytest.mark.parametrize("name,cvmode", BORDERS)
def test_warp_frames_batch_matches_cv2(burst, name, cvmode, perspective):
    """Every frame of the batch equals cv2.warpPerspective /
    warpAffine with the same border mode (BORDER_TRANSPARENT over a
    zero destination)."""
    frames, mats = burst
    if not perspective:
        mats = mats.copy()
        mats[:, 2] = (0.0, 0.0, 1.0)
    h, w = frames.shape[1:3]
    got = np.asarray(warp_batch.warp_frames_batch(
        jnp.asarray(frames), jnp.asarray(mats), perspective=perspective,
        border_value=0.25 if name == "constant" else 0.0, border_mode=name,
    ))
    for i in range(len(frames)):
        dst = np.zeros_like(frames[i])
        if perspective:
            want = cv2.warpPerspective(
                frames[i], mats[i].astype(np.float64), (w, h), dst=dst,
                flags=cv2.INTER_LINEAR, borderMode=cvmode,
                borderValue=(0.25,) * 3,
            )
        else:
            want = cv2.warpAffine(
                frames[i], mats[i, :2].astype(np.float64), (w, h), dst=dst,
                flags=cv2.INTER_LINEAR, borderMode=cvmode,
                borderValue=(0.25,) * 3,
            )
        _assert_warp_close(got[i], want)


@pytest.mark.parametrize("hw", [(192, 400), (161, 512), (97, 391)])
def test_warp_frames_batch_non_aligned_sizes(hw):
    """Sizes that are not multiples of any tile: the batched warp of a
    [N,H,W] stack equals the per-frame cv2 warp."""
    rng = np.random.default_rng(hw[0])
    h, w = hw
    frames = np.stack([
        cv2.GaussianBlur(rng.random((h, w)).astype(np.float32), (5, 5), 1.2)
        for _ in range(2)
    ])
    mats = np.stack([
        np.array([[1.0, 0.01, 4.5], [-0.01, 1.0, -3.25], [0, 0, 1]]),
        np.array([[0.99, 0.0, -7.0], [0.0, 1.01, 2.5], [0, 0, 1]]),
    ]).astype(np.float32)
    got = np.asarray(warp_batch.warp_frames_batch(
        jnp.asarray(frames), jnp.asarray(mats)
    ))
    for i in range(2):
        want = cv2.warpPerspective(
            frames[i], mats[i].astype(np.float64), (w, h),
            flags=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
        )
        _assert_warp_close(got[i], want)


def _assert_sum_close(got, want):
    """The accumulation compiles the coordinate arithmetic separately
    from the batched warp, so a few pixels on a 1/32-bin rounding
    boundary take the neighbouring tap."""
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert (d > 1e-5).mean() <= 1e-3, (d > 1e-5).mean()
    assert d.max() < 0.02, d.max()


def _masked_sum(frames, mats, oks, perspective=True, border_value=0.0):
    warped = warp_batch.warp_frames_batch(
        color.to_unit_f32(jnp.asarray(frames)), jnp.asarray(mats),
        perspective=perspective, border_value=border_value,
    )
    return np.asarray(jnp.sum(
        warped * jnp.asarray(oks, jnp.float32)[:, None, None, None], axis=0
    ))


@pytest.mark.parametrize("perspective", [True, False])
def test_warp_accumulate_matches_masked_sum(burst, perspective):
    """warp_accumulate_rgb (frame-by-frame accumulation) equals the
    masked sum of the batched warps."""
    frames, mats = burst
    oks = np.asarray([True, True, False, True])
    got = np.asarray(warp_batch.warp_accumulate_rgb(
        jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks),
        perspective=perspective,
    ))
    want = _masked_sum(frames, mats, oks, perspective)
    _assert_sum_close(got, want)


def test_warp_accumulate_dropped_lane_nan_matrix(burst):
    """A dropped lane's NaN matrix never reaches the warp: the result
    is the sum of the kept lanes, finite everywhere."""
    frames, mats = burst
    mats = mats.copy()
    mats[1] = np.nan
    oks = np.asarray([True, False, True, True])
    got = np.asarray(warp_batch.warp_accumulate_rgb(
        jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks),
    ))
    assert np.isfinite(got).all()
    keep = [0, 2, 3]
    want = _masked_sum(frames[keep], mats[keep], np.ones(3, bool))
    _assert_sum_close(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_warp_accumulate_integer_sources_bitwise(dtype):
    """Raw uint8/uint16 bursts are widened frame by frame: the result is
    bitwise the one of feeding color.to_unit_f32(frames)."""
    rng = np.random.default_rng(79)
    h, w = 61, 93
    raw = rng.integers(0, 256, (3, h, w, 3), np.uint8).astype(dtype)
    if dtype == np.uint16:
        raw = raw * 257
    mats = np.stack([np.eye(3, dtype=np.float32)] * 3)
    mats[1, 0, 2], mats[1, 1, 2] = -3.5, 2.25
    mats[2, 0, 2] = 5.0
    oks = jnp.asarray([True, True, False])
    a = np.asarray(warp_batch.warp_accumulate_rgb(
        color.to_unit_f32(jnp.asarray(raw)), jnp.asarray(mats), oks,
    ))
    b = np.asarray(warp_batch.warp_accumulate_rgb(
        jnp.asarray(raw), jnp.asarray(mats), oks,
    ))
    np.testing.assert_array_equal(a, b)


def test_warp_accumulate_border_value(burst):
    """BORDER_CONSTANT fill: pixels mapping outside take the per-channel
    border value."""
    frames, mats = burst
    bv = jnp.asarray([0.2, 0.5, 0.8], jnp.float32)
    oks = np.ones(4, bool)
    got = np.asarray(warp_batch.warp_accumulate_rgb(
        jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks),
        border_value=bv,
    ))
    want = _masked_sum(frames, mats, oks, border_value=bv)
    _assert_sum_close(got, want)


def test_large_translation_leaves_the_image(burst):
    """A warp that moves the frame entirely outside yields the border
    value everywhere."""
    frames, _ = burst
    m = np.eye(3, dtype=np.float32)
    m[0, 2] = 500.0
    got = np.asarray(warp_batch.warp_frames_batch(
        jnp.asarray(frames[:1]), jnp.asarray(m)[None], border_value=0.5,
    ))
    np.testing.assert_array_equal(got, 0.5)


def test_large_rotation(burst):
    """Large motion has no band limit on the gather path: a 30 degree
    rotation matches cv2."""
    frames, _ = burst
    h, w = frames.shape[1:3]
    m = np.vstack([
        cv2.getRotationMatrix2D((w / 2, h / 2), 30.0, 1.0), [0, 0, 1]
    ]).astype(np.float32)
    got = np.asarray(warp_batch.warp_frames_batch(
        jnp.asarray(frames[:1]), jnp.asarray(m)[None],
        border_mode=constants.BORDER_REPLICATE,
    ))[0]
    want = cv2.warpPerspective(
        frames[0], m.astype(np.float64), (w, h), flags=cv2.INTER_LINEAR,
        borderMode=cv2.BORDER_REPLICATE,
    )
    _assert_warp_close(got, want)

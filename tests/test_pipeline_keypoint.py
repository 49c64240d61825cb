"""End-to-end ``keypoint_match`` quality tests (SURVEY.md §7 phase 5).

RANSAC + ORB are randomised in OpenCV too, so parity is statistical:
the stacked output must match the ground-truth-warp stack within
interpolation tolerance, and drop bookkeeping must follow the
reference's deterministic semantics."""

import cv2
import numpy as np
import pytest
from PIL import Image

from libstacker_tpu import (
    KeyPointMatchParameters,
    keypoint_match_arrays,
    keypoint_match_stream,
)


def _textured_burst(rng, n=4, h=240, w=320):
    small = rng.integers(0, 256, size=(h // 8, w // 8), dtype=np.uint8)
    base = cv2.resize(small, (w * 2, h * 2), interpolation=cv2.INTER_NEAREST)
    base = cv2.GaussianBlur(base, (3, 3), 0.8)
    frames, true_h = [], []
    for i in range(n):
        if i == 0:
            m = np.eye(3, dtype=np.float32)
        else:
            ang = rng.uniform(-1.0, 1.0)
            dx, dy = rng.uniform(-4, 4, 2)
            m23 = cv2.getRotationMatrix2D((w, h), ang, 1.0).astype(np.float32)
            m23[0, 2] += dx
            m23[1, 2] += dy
            m = np.vstack([m23, [0, 0, 1]]).astype(np.float32)
        cur = cv2.warpPerspective(
            base, m, (w * 2, h * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )
        crop = cur[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([crop] * 3, axis=-1))
        true_h.append(m)
    return np.stack(frames), true_h


def _truth_stack(frames, true_h, h, w):
    """Average of frames warped with the KNOWN homographies (maps
    frame-i coords -> frame-0 coords, in crop coordinates)."""
    off = np.array([[1, 0, w // 2], [0, 1, h // 2], [0, 0, 1]], np.float64)
    off_inv = np.linalg.inv(off)
    acc = frames[0].astype(np.float32) / 255.0
    for i in range(1, len(frames)):
        # h_i maps frame-i crop coords -> frame-0 crop coords; cv2 inverts
        # internally, so pass it directly (out(x,y) = frame_i(h_i^-1 (x,y)))
        h_i = off_inv @ np.linalg.inv(true_h[0]) @ true_h[i] @ off
        warped = cv2.warpPerspective(
            frames[i].astype(np.float32) / 255.0,
            h_i.astype(np.float32),
            (w, h),
        )
        acc += warped
    return acc / len(frames)


def test_keypoint_match_quality(rng):
    frames, true_h = _textured_burst(rng)
    n, h, w = frames.shape[:3]
    dropped, got = keypoint_match_arrays(
        frames,
        KeyPointMatchParameters(ransac_reproj_threshold=5.0, match_ratio=0.9,
                                match_keep_ratio=0.8),
    )
    assert dropped == 0
    expected = _truth_stack(frames, true_h, h, w)
    m = 16
    diff = np.abs(got[m:-m, m:-m] - expected[m:-m, m:-m])
    assert np.quantile(diff, 0.99) < 0.04, f"p99 diff {np.quantile(diff, 0.99)}"


def test_keypoint_match_scaled(rng):
    frames, true_h = _textured_burst(rng)
    n, h, w = frames.shape[:3]
    dropped, got = keypoint_match_arrays(
        frames,
        KeyPointMatchParameters(ransac_reproj_threshold=5.0, match_ratio=0.9,
                                match_keep_ratio=0.8),
        scale_down_width=200.0,
    )
    assert dropped == 0
    expected = _truth_stack(frames, true_h, h, w)
    m = 16
    diff = np.abs(got[m:-m, m:-m] - expected[m:-m, m:-m])
    assert np.quantile(diff, 0.99) < 0.08


def test_keypoint_match_drops_featureless_frame(rng):
    frames, _ = _textured_burst(rng, n=3)
    # frame 2 becomes a flat image: no FAST corners -> no matches -> dropped
    frames = frames.copy()
    frames[2] = 128
    dropped, got = keypoint_match_arrays(
        frames, KeyPointMatchParameters(match_ratio=0.9)
    )
    assert dropped == 1
    assert np.isfinite(got).all()


def test_keypoint_match_lmeds(rng):
    from libstacker_tpu import constants

    frames, true_h = _textured_burst(rng, n=3)
    n, h, w = frames.shape[:3]
    dropped, got = keypoint_match_arrays(
        frames,
        KeyPointMatchParameters(
            method=constants.LMEDS, match_ratio=0.9, match_keep_ratio=0.8
        ),
    )
    assert dropped == 0
    expected = _truth_stack(frames, true_h, h, w)
    m = 16
    diff = np.abs(got[m:-m, m:-m] - expected[m:-m, m:-m])
    assert np.quantile(diff, 0.99) < 0.05


def test_keypoint_match_stats(rng):
    frames, _ = _textured_burst(rng, n=3)
    dropped, got, stats = keypoint_match_arrays(
        frames, KeyPointMatchParameters(match_ratio=0.9), return_stats=True
    )
    assert stats.frames_total == 3
    assert stats.frames_kept == 3 - dropped
    assert len(stats.match_counts) == 2
    assert all(c >= 5 for c in stats.match_counts)
    assert all(i >= 4 for i in stats.inlier_counts)


def test_keypoint_match_stream_matches_batch(rng, tmp_path):
    """Chunked streaming (chunk_size=2, 5 frames -> padded final chunk)
    equals the whole-burst result within interpolation tolerance."""
    frames, _ = _textured_burst(rng, n=5)
    files = []
    for i, f in enumerate(frames):
        p = tmp_path / f"frame{i}.png"
        Image.fromarray(f).save(p)
        files.append(p)
    dropped_b, batch = keypoint_match_arrays(frames, seed=7)
    dropped_s, stream = keypoint_match_stream(files, seed=7, chunk_size=2)
    assert dropped_s == dropped_b == 0
    # RANSAC draws differ between the two paths (per-chunk keys), so
    # compare stacked images, not homographies
    m = 16
    diff = np.abs(stream[m:-m, m:-m] - batch[m:-m, m:-m])
    assert np.quantile(diff, 0.99) < 0.02
    assert diff.max() < 0.2


def test_keypoint_match_single_frame_stats():
    """n==1 must keep the same return arity as n>1 (r2 VERDICT item 5):
    3-tuple with stats under return_stats=True, 2-tuple otherwise."""
    frames, _ = _textured_burst(np.random.default_rng(44), n=1)
    dropped, got = keypoint_match_arrays(frames)
    assert dropped == 0
    np.testing.assert_allclose(got, frames[0].astype(np.float32) / 255.0)
    dropped, got, stats = keypoint_match_arrays(frames, return_stats=True)
    assert dropped == 0
    assert stats.frames_total == 1
    assert stats.frames_kept == 1
    assert stats.frames_dropped == 0


@pytest.mark.parametrize("border", ["constant", "replicate"])
def test_keypoint_stack_matches_cv2_warps(border):
    """Stage 3 with BORDER_CONSTANT (frame-by-frame accumulation) and
    BORDER_REPLICATE (batched warp + masked sum): the stack equals the
    mean of cv2.warpPerspective of every frame with the pipeline's own
    homographies and border mode."""
    import jax
    import jax.numpy as jnp

    from libstacker_tpu import constants
    from libstacker_tpu.models import keypoint as kp

    mode = {"constant": (constants.BORDER_CONSTANT, cv2.BORDER_CONSTANT),
            "replicate": (constants.BORDER_REPLICATE,
                          cv2.BORDER_REPLICATE)}[border]
    frames, _ = _textured_burst(np.random.default_rng(48), n=3, h=192, w=512)
    params = KeyPointMatchParameters(match_ratio=0.9, border_mode=mode[0])
    dropped, got = keypoint_match_arrays(frames, params, seed=5)
    assert dropped == 0
    feats = kp.detect_features_chunked(jnp.asarray(frames))
    hs, oks, _, _ = kp._match_and_estimate(
        feats, jax.random.PRNGKey(5), method=params.method,
        ransac_reproj_threshold=params.ransac_reproj_threshold,
        match_keep_ratio=params.match_keep_ratio,
        match_ratio=params.match_ratio, max_iters=params.max_iters,
        confidence=params.confidence,
    )
    assert np.asarray(oks).all()
    h, w = frames.shape[1:3]
    f32 = frames.astype(np.float32) / 255.0
    acc = f32[0].copy()
    for i in range(1, 3):
        acc += cv2.warpPerspective(
            f32[i], np.asarray(hs[i - 1], np.float64), (w, h),
            flags=cv2.INTER_LINEAR, borderMode=mode[1],
        )
    d = np.abs(got - acc / 3.0)
    # f32 vs f64 coordinates: rare 1/32-px bin flips, one step each
    assert (d > 5e-3).mean() < 0.01, (d > 5e-3).mean()
    assert d.max() < 0.06, d.max()


def test_keypoint_match_tiny_scale_drops_all():
    """scale_down_width small enough that no pyramid level survives the
    edge_threshold check must degrade to empty features -> all frames
    dropped -> frame 0 returned, not crash (the reference keypoint path
    has no minimum-width guard, src/lib.rs:377-382; OpenCV's ORB simply
    finds nothing on a tiny image)."""
    frames, _ = _textured_burst(np.random.default_rng(47), n=3)
    dropped, got = keypoint_match_arrays(frames, scale_down_width=12)
    assert dropped == 2
    np.testing.assert_allclose(got, frames[0].astype(np.float32) / 255.0)


def test_detect_chunk_budget_fence():
    """Fence for the 4K detection chunk budget: 20 frames per chunk at
    4K.  Change it only together with a measurement of the detect
    stage on the GPU."""
    from libstacker_tpu.models.keypoint import detect_chunk_budget

    chunk_4k = detect_chunk_budget(100, 2160, 3840)
    assert chunk_4k == 20, chunk_4k
    # smaller grids may batch more, monotonically
    assert detect_chunk_budget(100, 1080, 1920) >= chunk_4k
    assert detect_chunk_budget(3, 2160, 3840) == 3  # never exceeds n


def test_detect_scan_matches_per_chunk_loop(monkeypatch):
    """The scan-over-chunks detection program (one dispatch) must
    produce bit-identical features to the r3 per-chunk dispatch loop,
    including the padded-tail case (n=5, chunk=2)."""
    import jax.numpy as jnp

    from libstacker_tpu.models import keypoint as kp

    rng = np.random.default_rng(53)
    small = rng.integers(0, 256, (96 // 8, 128 // 8), np.uint8)
    frames = np.stack([
        np.stack([np.roll(small.repeat(8, 0).repeat(8, 1), i, 1)] * 3, -1)
        for i in range(5)
    ])
    fj = jnp.asarray(frames)
    monkeypatch.setenv("LIBSTACKER_DETECT_SCAN", "0")
    loop = kp.detect_features_chunked(fj, chunk=2)
    monkeypatch.setenv("LIBSTACKER_DETECT_SCAN", "1")
    scan = kp.detect_features_chunked(fj, chunk=2)
    for name in loop._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(scan, name)),
            np.asarray(getattr(loop, name)),
            err_msg=name,
        )
    # scaled grid + detection mask ride the scan body too
    mask = np.zeros((96, 128), np.float32)
    mask[:, 64:] = 1.0
    monkeypatch.setenv("LIBSTACKER_DETECT_SCAN", "0")
    loop_m = kp.detect_features_chunked(
        fj, chunk=3, det_mask=jnp.asarray(mask)
    )
    monkeypatch.setenv("LIBSTACKER_DETECT_SCAN", "1")
    scan_m = kp.detect_features_chunked(
        fj, chunk=3, det_mask=jnp.asarray(mask)
    )
    for name in loop_m._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(scan_m, name)),
            np.asarray(getattr(loop_m, name)),
            err_msg=name,
        )

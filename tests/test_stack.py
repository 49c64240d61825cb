"""Kappa-sigma clipped stacking (ops/stack.py — beyond-reference).

The reference can only average (src/lib.rs:306-343 / 807-843); the
sigma_clip mode rejects per-pixel outliers (satellite trails, hot
pixels, single-frame glitches).  Oracle: a pure-numpy pixelwise
kappa-sigma reduction (identity warps make the re-warping formulation
collapse to it exactly), plus end-to-end outlier-suppression checks
through both pipelines.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from libstacker_tpu import (
    EccMatchParameters,
    KeyPointMatchParameters,
    MotionType,
    ecc_match_arrays,
    keypoint_match_arrays,
)
from libstacker_tpu.errors import InvalidParamsError
from libstacker_tpu.ops import stack


def _numpy_kappa_sigma(v, kappa, iters):
    """Pixelwise oracle over the frame axis of [N,H,W,3] floats."""
    mu = v.mean(0)
    var = (v * v).mean(0) - mu * mu
    for _ in range(iters):
        tol = kappa * np.sqrt(np.maximum(var, 0)) + np.float32(0.5 / 255)
        m = np.abs(v - mu) <= tol
        c0 = m.sum(0).astype(np.float32)
        c1 = (m * v).sum(0)
        c2 = (m * v * v).sum(0)
        c1 = np.where(c0 > 0, c1, mu)
        c2 = np.where(c0 > 0, c2, mu * mu)
        c0 = np.maximum(c0, 1.0)
        mu = c1 / c0
        var = np.maximum(c2 / c0 - mu * mu, 0.0)
    return mu


def test_identity_warps_match_numpy_oracle():
    rng = np.random.default_rng(11)  # local rng (conftest stream note)
    n, h, w = 7, 24, 32
    frames = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    mats = np.stack([np.eye(3, dtype=np.float32)] * (n - 1))
    oks = np.ones(n - 1, bool)
    for kappa, iters in ((1.0, 2), (2.5, 1)):
        out, frac = stack.kappa_sigma_stack(
            jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks),
            perspective=True, kappa=kappa, iters=iters, chunk=3,
        )
        want = _numpy_kappa_sigma(
            frames.astype(np.float32) / 255.0, kappa, iters
        )
        np.testing.assert_allclose(np.asarray(out), want, atol=2e-6)
        assert 0.0 <= frac <= 1.0


def test_dropped_lane_and_affine_mats_excluded():
    """ok=False lanes contribute nothing even with NaN matrices, and
    2x3 affine matrices are accepted."""
    rng = np.random.default_rng(13)
    n, h, w = 5, 16, 24
    frames = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    mats = np.stack([np.eye(3, dtype=np.float32)[:2]] * (n - 1))
    oks = np.ones(n - 1, bool)
    oks[2] = False
    mats[2] = np.nan
    out, _ = stack.kappa_sigma_stack(
        jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks),
        perspective=False, kappa=3.0, iters=1, chunk=2,
    )
    keep = np.ones(n, bool)
    keep[3] = False  # frame index 3 == lane 2
    want = _numpy_kappa_sigma(
        frames[keep].astype(np.float32) / 255.0, 3.0, 1
    )
    np.testing.assert_allclose(np.asarray(out), want, atol=2e-6)


@pytest.fixture(scope="module")
def streak_burst():
    """8 shifted copies of a smooth base; frame 3 carries a bright
    streak (the classic satellite trail).  Returns (clean, dirty)."""
    rng = np.random.default_rng(17)
    h, w = 96, 128
    base = cv2.GaussianBlur(
        rng.integers(40, 200, (h, w, 3), np.uint8).astype(np.uint8),
        (0, 0), 3.0,
    )
    clean = []
    for i in range(8):
        # integer shifts: exact translations with no resampling-phase
        # aliasing (CLAUDE.md trap), so every ECC lane converges
        dx, dy = int(rng.integers(-3, 4)), int(rng.integers(-3, 4))
        f = np.roll(base, (dy, dx), (0, 1))
        noise = rng.normal(0, 2.0, f.shape)
        clean.append(np.clip(f.astype(np.float32) + noise, 0, 255)
                     .astype(np.uint8))
    clean = np.stack(clean)
    dirty = clean.copy()
    streaked = dirty[3].copy()
    cv2.line(streaked, (10, 20), (110, 70), (255, 255, 255), 2)
    dirty[3] = streaked
    streak_mask = np.zeros((h, w), np.uint8)
    cv2.line(streak_mask, (10, 20), (110, 70), 1, 2)
    return clean, dirty, streak_mask.astype(bool)


def test_ecc_sigma_clip_suppresses_streak(streak_burst):
    clean, dirty, streak = streak_burst
    params = dict(
        motion_type=MotionType.Translation, max_count=80, epsilon=1e-4
    )
    mean_clean = ecc_match_arrays(clean, EccMatchParameters(**params))
    mean_dirty = ecc_match_arrays(dirty, EccMatchParameters(**params))
    sig_dirty = ecc_match_arrays(
        dirty,
        EccMatchParameters(
            **params, stacking="sigma_clip", sigma_kappa=2.5, sigma_iters=2
        ),
    )
    core = streak & ~np.roll(streak, 3, 0)  # keep off-centre bleed out
    err_mean = np.abs(mean_dirty - mean_clean)[core].mean()
    err_sig = np.abs(sig_dirty - mean_clean)[core].mean()
    assert err_mean > 0.02, err_mean  # the ghost the mean cannot avoid
    assert err_sig < 0.25 * err_mean, (err_sig, err_mean)
    # away from the streak both estimators agree with the clean mean
    far = ~cv2.dilate(streak.astype(np.uint8), np.ones((9, 9))).astype(bool)
    far[:8] = far[-8:] = False
    far[:, :8] = far[:, -8:] = False
    assert np.abs(sig_dirty - mean_clean)[far].mean() < 0.01


def test_keypoint_sigma_clip_suppresses_streak():
    rng = np.random.default_rng(19)
    h, w = 192, 256
    base = cv2.resize(
        rng.integers(0, 256, (h // 8, w // 8, 3), np.uint8).astype(np.uint8),
        (w, h), interpolation=cv2.INTER_NEAREST,
    )
    frames = []
    for i in range(6):
        dx, dy = int(rng.integers(-4, 5)), int(rng.integers(-4, 5))
        frames.append(np.roll(base, (dy, dx), (0, 1)))
    frames = np.stack(frames)
    dirty = frames.copy()
    streaked = dirty[2].copy()
    cv2.line(streaked, (30, 40), (220, 150), (255, 255, 255), 3)
    dirty[2] = streaked
    streak = np.zeros((h, w), np.uint8)
    cv2.line(streak, (30, 40), (220, 150), 1, 3)
    streak = streak.astype(bool)

    d0, mean_out = keypoint_match_arrays(dirty, KeyPointMatchParameters())
    d1, sig_out = keypoint_match_arrays(
        dirty,
        KeyPointMatchParameters(
            stacking="sigma_clip", sigma_kappa=2.0, sigma_iters=2
        ),
    )
    assert d0 == 0 and d1 == 0
    clean_ref = frames[0].astype(np.float32) / 255.0
    interior = np.zeros((h, w), bool)
    interior[16:-16, 16:-16] = True
    core = streak & interior
    err_mean = np.abs(mean_out - clean_ref)[core].mean()
    err_sig = np.abs(sig_out - clean_ref)[core].mean()
    assert err_mean > 0.02, err_mean
    assert err_sig < 0.25 * err_mean, (err_sig, err_mean)


def test_sigma_clip_param_validation_and_streaming_guard(tmp_path):
    with pytest.raises(InvalidParamsError):
        KeyPointMatchParameters(stacking="median").validate()
    with pytest.raises(InvalidParamsError):
        KeyPointMatchParameters(
            stacking="sigma_clip", sigma_kappa=0.0
        ).validate()
    with pytest.raises(InvalidParamsError):
        EccMatchParameters(
            motion_type=MotionType.Translation,
            stacking="sigma_clip", sigma_iters=0,
        ).validate()
    # non-constant border modes have no coverage notion
    from libstacker_tpu import constants

    frames = np.zeros((2, 32, 32, 3), np.uint8)
    with pytest.raises(InvalidParamsError):
        keypoint_match_arrays(
            frames,
            KeyPointMatchParameters(
                stacking="sigma_clip",
                border_mode=constants.BORDER_REPLICATE,
            ),
        )
    # streaming sigma-clip + checkpoint COMPOSES since r5 (r4 VERDICT
    # item 9; kill-and-resume covered by test_stream_checkpoint.py) —
    # a 1-frame burst degenerates to the reference frame and completes
    from libstacker_tpu import ecc_match_stream, keypoint_match_stream

    p = tmp_path / "f0.png"
    cv2.imwrite(str(p), np.zeros((32, 32, 3), np.uint8))
    out = ecc_match_stream(
        [str(p)],
        EccMatchParameters(
            motion_type=MotionType.Translation, stacking="sigma_clip"
        ),
        checkpoint_path=str(tmp_path / "ck.npz"),
    )
    assert out.shape == (32, 32, 3)
    _, out = keypoint_match_stream(
        [str(p)], KeyPointMatchParameters(stacking="sigma_clip"),
        checkpoint_path=str(tmp_path / "ck2.npz"),
    )
    assert out.shape == (32, 32, 3)
    # super-resolution still refuses to stream
    with pytest.raises(InvalidParamsError, match="output_scale"):
        ecc_match_stream(
            [str(p)],
            EccMatchParameters(
                motion_type=MotionType.Translation, output_scale=2
            ),
        )


def test_ecc_sigma_clip_scaled_path_and_stats(streak_burst):
    """The scale-down branch rescales warps before the robust stack,
    and return_stats surfaces the clipped-sample fraction."""
    clean, dirty, streak = streak_burst
    params = dict(
        motion_type=MotionType.Translation, max_count=80, epsilon=1e-4
    )
    # drop mode: tiny scaled greys can genuinely fail a lane, and it
    # also exercises the sigma branch of the not-all-ok path
    mean_clean = ecc_match_arrays(
        clean, EccMatchParameters(**params), scale_down_width=96.0,
        on_failure="drop",
    )
    sig_dirty, stats = ecc_match_arrays(
        dirty,
        EccMatchParameters(
            **params, stacking="sigma_clip", sigma_kappa=2.5, sigma_iters=2
        ),
        scale_down_width=96.0,
        on_failure="drop",
        return_stats=True,
    )
    mean_dirty = ecc_match_arrays(
        dirty, EccMatchParameters(**params), scale_down_width=96.0,
        on_failure="drop",
    )
    assert stats.frames_kept >= 7  # the burst must mostly converge
    assert stats.clipped_sample_frac is not None
    assert 0.0 < stats.clipped_sample_frac < 0.2
    core = streak & ~np.roll(streak, 3, 0)
    err_mean = np.abs(mean_dirty - mean_clean)[core].mean()
    err_sig = np.abs(sig_dirty - mean_clean)[core].mean()
    assert err_mean > 0.02, err_mean
    assert err_sig < 0.25 * err_mean, (err_sig, err_mean)


def _kappa_sigma_oracle(frames, mats, oks, kappa, iters):
    """Per-pixel kappa-sigma over ALL warped samples at once (numpy,
    float64): the semantics ops/stack.py streams as moment sweeps."""
    from libstacker_tpu.ops.warp_batch import warp_frames_batch

    n, h, w = frames.shape[:3]
    m_all = np.concatenate([np.eye(3, dtype=np.float32)[None], mats])
    ok_all = np.concatenate([[True], oks])
    f = frames.astype(np.float32) / 255.0
    wf = np.asarray(
        warp_frames_batch(jnp.asarray(f), jnp.asarray(m_all)), np.float64
    )
    cov = np.asarray(stack._coverage(jnp.asarray(m_all), h, w, True))
    incl = (cov & ok_all[:, None, None])[..., None] & np.ones(3, bool)
    tol0 = 0.5 / 255.0
    s0 = incl.sum(0).astype(np.float64)
    mu = (wf * incl).sum(0) / np.maximum(s0, 1)
    var = np.maximum((wf * wf * incl).sum(0) / np.maximum(s0, 1) - mu**2, 0)
    for _ in range(iters):
        keep = incl & (np.abs(wf - mu) <= kappa * np.sqrt(var) + tol0)
        c0 = keep.sum(0).astype(np.float64)
        c1 = (wf * keep).sum(0)
        c2 = (wf * wf * keep).sum(0)
        c1 = np.where(c0 > 0, c1, mu)
        c2 = np.where(c0 > 0, c2, mu * mu)
        c0 = np.maximum(c0, 1.0)
        mu = c1 / c0
        var = np.maximum(c2 / c0 - mu**2, 0.0)
    return mu


@pytest.mark.parametrize("hw", [(96, 128), (61, 93)])
def test_kappa_sigma_matches_numpy_oracle(hw):
    """kappa_sigma_stack's chunked (1+iters) moment sweeps equal the
    per-pixel clip over all samples at once, on aligned and
    non-aligned sizes, with a dropped lane."""
    rng = np.random.default_rng(23)  # local rng (conftest stream note)
    n = 5
    h, w = hw
    base = cv2.GaussianBlur(
        rng.integers(0, 256, (h, w, 3), np.uint8).astype(np.uint8),
        (0, 0), 2.0,
    )
    frames = np.stack([
        np.roll(base, (int(rng.integers(-3, 4)), int(rng.integers(-3, 4))),
                (0, 1))
        for _ in range(n)
    ])
    frames[2, 20:24, 10:60] = 255  # one-frame glitch to clip
    mats = np.stack([np.eye(3, dtype=np.float32)] * (n - 1))
    for i in range(n - 1):
        mats[i, 0, 2] = 1.25 * i - 2.0
        mats[i, 1, 2] = -0.75 * i + 1.0
    oks = np.ones(n - 1, bool)
    oks[1] = False
    mats[1] = np.nan  # a dropped lane's matrix never reaches the warp
    got, _ = stack.kappa_sigma_stack(
        jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks),
        kappa=2.0, iters=2, chunk=3,
    )
    want = _kappa_sigma_oracle(
        frames, np.where(oks[:, None, None], mats, np.eye(3)), oks, 2.0, 2
    )
    d = np.abs(np.asarray(got, np.float64) - want)
    # f32 moments vs f64 oracle: samples sitting exactly on the clip
    # boundary may flip
    assert (d > 1e-4).mean() <= 1e-3, (d > 1e-4).mean()
    assert d.max() < 0.05


def test_super_res_recovers_contrast():
    """super_res_stack on a near-Nyquist target: the shift-and-add
    nearest-sample deposit must recover clearly more of the truth's
    contrast than the bilinear mean (which low-passes it away), at
    lower RMSE."""
    rng = np.random.default_rng(3)
    hf = wf = 192
    yy, xx = np.mgrid[0:hf, 0:wf].astype(np.float64)
    truth = 0.5 + 0.25 * np.sin(0.9 * xx) + 0.25 * np.sin(0.9 * yy)

    def sample_lr(dy, dx):  # area-sample the shifted truth to LR
        sh = np.roll(np.roll(truth, -int(round(dy * 2)), 0),
                     -int(round(dx * 2)), 1)
        return sh.reshape(hf // 2, 2, wf // 2, 2).mean((1, 3))

    n = 16
    shifts = [(0.0, 0.0)] + [
        (round(rng.uniform(0, 1) * 2) / 2, round(rng.uniform(0, 1) * 2) / 2)
        for _ in range(n - 1)
    ]
    frames_f = np.stack([sample_lr(dy, dx) for dy, dx in shifts])
    frames = np.repeat(
        np.clip(np.round(frames_f * 255), 0, 255).astype(np.uint8)[..., None],
        3, axis=-1,
    )
    # f_i(x) = ref(x + d_i): forward map is the translation by d_i
    mats = np.stack([
        np.array([[1, 0, dx], [0, 1, dy], [0, 0, 1]], np.float32)
        for dy, dx in shifts[1:]
    ])
    oks = np.ones(n - 1, bool)
    sr = np.asarray(stack.super_res_stack(
        jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks),
        factor=2, kernel_sigma=0.3, perspective=False, chunk=5,
    ))[..., 0].astype(np.float64)

    h, w = hf // 2, wf // 2
    oy, ox = np.mgrid[0:hf, 0:wf].astype(np.float64)
    acc = np.zeros((hf, wf))
    for f, (dy, dx) in zip(frames_f, shifts):
        sy = (oy + 0.5) / 2 - 0.5 - dy
        sx = (ox + 0.5) / 2 - 0.5 - dx
        y0 = np.clip(np.floor(sy).astype(int), 0, h - 2)
        fy = np.clip(sy - y0, 0, 1)
        x0 = np.clip(np.floor(sx).astype(int), 0, w - 2)
        fx = np.clip(sx - x0, 0, 1)
        acc += (f[y0, x0] * (1 - fy) * (1 - fx)
                + f[y0, x0 + 1] * (1 - fy) * fx
                + f[y0 + 1, x0] * fy * (1 - fx)
                + f[y0 + 1, x0 + 1] * fy * fx)
    bl = acc / n

    crop = slice(8, -8)

    def rmse_contrast(x):
        r = np.sqrt(((x - truth)[crop, crop] ** 2).mean())
        a = (x - x.mean())[crop, crop]
        t = (truth - truth.mean())[crop, crop]
        return r, (a * t).mean() / (t * t).mean()

    r_bl, c_bl = rmse_contrast(bl)
    r_sr, c_sr = rmse_contrast(sr)
    assert c_sr > c_bl + 0.08, (c_sr, c_bl)
    assert r_sr < 0.75 * r_bl, (r_sr, r_bl)


def test_pipeline_output_scale():
    """output_scale=2 through keypoint_match_arrays: 2x output grid,
    content consistent with the mean stack when area-downsampled, and
    the combo/streaming guards hold."""
    rng = np.random.default_rng(29)
    h, w = 192, 256
    base = cv2.resize(
        rng.integers(0, 256, (h // 8, w // 8, 3), np.uint8).astype(np.uint8),
        (w, h), interpolation=cv2.INTER_NEAREST,
    )
    frames = np.stack([
        np.roll(base, (int(rng.integers(-3, 4)), int(rng.integers(-3, 4))),
                (0, 1))
        for _ in range(8)
    ])
    d0, mean_out = keypoint_match_arrays(frames, KeyPointMatchParameters())
    d1, sr_out = keypoint_match_arrays(
        frames, KeyPointMatchParameters(output_scale=2)
    )
    assert d0 == 0 and d1 == 0
    assert sr_out.shape == (2 * h, 2 * w, 3)
    down = sr_out.reshape(h, 2, w, 2, 3).mean((1, 3))
    core = np.abs(down - mean_out)[10:-10, 10:-10]
    assert core.mean() < 0.02, core.mean()

    # single-frame burst upsamples frame 0
    d2, one = keypoint_match_arrays(
        frames[:1], KeyPointMatchParameters(output_scale=2)
    )
    assert d2 == 0 and one.shape == (2 * h, 2 * w, 3)

    with pytest.raises(InvalidParamsError):
        KeyPointMatchParameters(output_scale=5).validate()
    with pytest.raises(InvalidParamsError):
        KeyPointMatchParameters(
            output_scale=2, stacking="sigma_clip"
        ).validate()
    from libstacker_tpu import keypoint_match_stream

    with pytest.raises(InvalidParamsError):
        keypoint_match_stream(
            ["x.png"], KeyPointMatchParameters(output_scale=2)
        )


def test_ecc_stream_sigma_clip_matches_whole_burst(tmp_path):
    """r3 VERDICT item 6: streaming sigma-clip — stream-vs-whole-burst
    parity at n >= 16 with an injected outlier frame.  The stream's
    align pass stores the warps, then the S0/S1/S2 moment passes
    re-stream the files (ops/stack.py's accumulators compose over
    chunks exactly)."""
    from libstacker_tpu import ecc_match_stream

    rng = np.random.default_rng(31)
    h, w = 96, 128
    base = cv2.GaussianBlur(
        rng.integers(40, 200, (h, w, 3), np.uint8).astype(np.uint8),
        (0, 0), 3.0,
    )
    frames = []
    for i in range(16):
        dx, dy = int(rng.integers(-3, 4)), int(rng.integers(-3, 4))
        f = np.roll(base, (dy, dx), (0, 1))
        noise = rng.normal(0, 2.0, f.shape)
        frames.append(np.clip(f.astype(np.float32) + noise, 0, 255)
                      .astype(np.uint8))
    frames = np.stack(frames)
    streaked = frames[5].copy()
    cv2.line(streaked, (10, 20), (110, 70), (255, 255, 255), 2)
    frames[5] = streaked
    files = []
    for i, f in enumerate(frames):
        p = tmp_path / f"f{i:02d}.png"
        cv2.imwrite(str(p), f[..., ::-1])
        files.append(str(p))
    params = EccMatchParameters(
        motion_type=MotionType.Translation, max_count=80, epsilon=1e-4,
        stacking="sigma_clip", sigma_kappa=2.5, sigma_iters=2,
    )
    whole, wstats = ecc_match_arrays(frames, params, return_stats=True)
    streamed, sstats = ecc_match_stream(
        files, params, chunk_size=5, return_stats=True
    )
    assert sstats.frames_kept == wstats.frames_kept
    assert sstats.clipped_sample_frac is not None
    assert sstats.clipped_sample_frac > 0.0  # the streak was rejected
    # near-exact: the stream's chunk grouping (5 vs the whole-burst 8)
    # reorders the float moment sums, which can flip a sample sitting
    # exactly on the kappa boundary at isolated pixels
    diff = np.abs(streamed - whole)
    assert (diff <= 1e-4).mean() > 0.999
    assert diff.max() < 0.05
    # the streak must actually be suppressed, not merely averaged
    clean_mean = ecc_match_arrays(
        np.concatenate([frames[:5], frames[6:]]),
        EccMatchParameters(
            motion_type=MotionType.Translation, max_count=80, epsilon=1e-4
        ),
    )
    streak = np.zeros((h, w), np.uint8)
    cv2.line(streak, (10, 20), (110, 70), 1, 2)
    core = streak.astype(bool)
    assert np.abs(streamed - clean_mean)[core].mean() < 0.01


def test_keypoint_stream_sigma_clip_matches_whole_burst(tmp_path):
    from libstacker_tpu import keypoint_match_stream

    rng = np.random.default_rng(33)
    h, w = 192, 256
    base = cv2.resize(
        rng.integers(0, 256, (h // 8, w // 8, 3), np.uint8).astype(np.uint8),
        (w, h), interpolation=cv2.INTER_NEAREST,
    )
    frames = []
    for i in range(9):
        dx, dy = int(rng.integers(-4, 5)), int(rng.integers(-4, 5))
        frames.append(np.roll(base, (dy, dx), (0, 1)))
    frames = np.stack(frames)
    streaked = frames[4].copy()
    cv2.line(streaked, (30, 40), (220, 150), (255, 255, 255), 3)
    frames[4] = streaked
    files = []
    for i, f in enumerate(frames):
        p = tmp_path / f"k{i:02d}.png"
        cv2.imwrite(str(p), f[..., ::-1])
        files.append(str(p))
    params = KeyPointMatchParameters(
        stacking="sigma_clip", sigma_kappa=2.0, sigma_iters=1
    )
    wd, whole = keypoint_match_arrays(frames, params, seed=3)
    sd, streamed, st = keypoint_match_stream(
        files, params, chunk_size=4, seed=3, return_stats=True
    )
    assert wd == sd == 0
    assert st.clipped_sample_frac is not None and st.clipped_sample_frac > 0
    # the RANSAC RNG stream differs between the batched (one key split
    # over n-1) and streaming (per-chunk splits) paths: statistical
    # agreement, not bitwise
    assert np.mean(np.abs(streamed - whole)) < 5e-3


@pytest.mark.parametrize("hw", [(61, 93), (40, 128)])
def test_moment_sweeps_match_numpy_on_non_aligned_sizes(hw):
    """One moments sweep and one clipped sweep (ops/stack.py
    _moments_chunk / _clipped_chunk) equal the numpy sums over the
    covered samples, on sizes that are not multiples of any tile."""
    from libstacker_tpu.ops.warp_batch import warp_frames_batch

    rng = np.random.default_rng(hw[0] + hw[1])
    h, w = hw
    frames = rng.integers(0, 256, (3, h, w, 3), np.uint8)
    mats = np.stack([np.eye(3, dtype=np.float32)] * 3)
    mats[1, 0, 2], mats[1, 1, 2] = 2.5, -1.25
    mats[2] = cv2.getRotationMatrix2D((w / 2, h / 2), 3.0, 1.0).tolist() + [
        [0, 0, 1]
    ]
    oks = np.asarray([True, True, False])
    s0, s1, s2 = (np.asarray(x, np.float64) for x in stack._moments_chunk(
        jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks), True
    ))
    wf = np.asarray(warp_frames_batch(
        jnp.asarray(frames, jnp.float32) / 255.0, jnp.asarray(mats)
    ), np.float64)
    incl = np.asarray(stack._coverage(jnp.asarray(mats), h, w, True))
    incl = incl & oks[:, None, None]
    np.testing.assert_allclose(s0, incl.sum(0))
    np.testing.assert_allclose(s1, (wf * incl[..., None]).sum(0), atol=1e-4)
    np.testing.assert_allclose(
        s2, (wf * wf * incl[..., None]).sum(0), atol=1e-4
    )
    mu = s1 / np.maximum(s0, 1)[..., None]
    tol = np.full((h, w, 3), 0.05)
    c0, c1, _ = (np.asarray(x, np.float64) for x in stack._clipped_chunk(
        jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks),
        jnp.asarray(mu, jnp.float32), jnp.asarray(tol, jnp.float32), True,
    ))
    keep = incl[..., None] & (np.abs(wf - mu) <= tol)
    # samples within 1 ulp of the tolerance edge may land either side
    assert (np.abs(c0 - keep.sum(0)) > 0).mean() < 1e-3
    assert np.abs(c1 - (wf * keep).sum(0)).max() < 1.0


@pytest.mark.parametrize("f", [2, 3])
def test_super_res_non_aligned_size_matches_numpy(f):
    """super_res_stack on a non-aligned size (chunked, tail-padded)
    equals the shift-and-add deposit computed directly in numpy."""
    rng = np.random.default_rng(88)
    n, h, w, sigma = 3, 23, 37, 0.3
    frames = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    mats = np.stack([np.eye(3, dtype=np.float32)] * (n - 1))
    mats[0, 0, 2], mats[0, 1, 2] = 0.5, -0.25
    mats[1, 0, 2], mats[1, 1, 2] = -0.3, 0.6
    oks = np.ones(n - 1, bool)
    got = np.asarray(stack.super_res_stack(
        jnp.asarray(frames), jnp.asarray(mats), jnp.asarray(oks),
        factor=f, kernel_sigma=sigma, chunk=2,
    ), np.float64)
    m_all = np.concatenate([np.eye(3)[None], mats.astype(np.float64)])
    gy = (np.arange(h * f)[:, None] + 0.5) / f - 0.5
    gx = (np.arange(w * f)[None, :] + 0.5) / f - 0.5
    av = np.zeros((h * f, w * f, 3))
    aw = np.zeros((h * f, w * f))
    for i in range(n):
        mi = np.linalg.inv(m_all[i])
        den = mi[2, 0] * gx + mi[2, 1] * gy + mi[2, 2]
        sx = (mi[0, 0] * gx + mi[0, 1] * gy + mi[0, 2]) / den
        sy = (mi[1, 0] * gx + mi[1, 1] * gy + mi[1, 2]) / den
        qx, qy = np.round(sx), np.round(sy)
        inside = (qy >= 0) & (qy <= h - 1) & (qx >= 0) & (qx <= w - 1)
        wgt = np.where(
            inside, np.exp(-((sy - qy) ** 2 + (sx - qx) ** 2)
                           / (2 * sigma ** 2)), 0.0,
        )
        v = frames[i][np.clip(qy, 0, h - 1).astype(int),
                      np.clip(qx, 0, w - 1).astype(int)] / 255.0
        av += wgt[..., None] * v
        aw += wgt
    want = av / np.maximum(aw, 1e-6)[..., None]
    assert got.shape == want.shape
    d = np.abs(got - want)
    # f32 vs f64 coordinates: a sample on a rounding tie may switch
    assert (d > 1e-4).mean() < 2e-3, (d > 1e-4).mean()
    assert np.median(d) < 1e-5

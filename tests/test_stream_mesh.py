"""Stream x mesh composition (r4 VERDICT item 3): the streaming
pipelines accept ``mesh=`` and shard every chunk over the 'data' axis —
bigger-than-HBM bursts can use every chip.  Parity target: the plain
whole-burst DENSE pipelines (no mesh), so these tests pin the full
composition stream+shard == reference semantics.  The reference sells
"memory efficient streaming processing" (src/lib.rs:106) and hides its
parallelism inside the API (src/lib.rs:188, 746); composing both is the
device equivalent."""

import cv2
import jax
import numpy as np
import pytest
from PIL import Image

from libstacker_tpu.models.ecc import ecc_match_arrays, ecc_match_stream
from libstacker_tpu.models.keypoint import (
    keypoint_match_arrays,
    keypoint_match_stream,
)
from libstacker_tpu.params import (
    EccMatchParameters,
    KeyPointMatchParameters,
    MotionType,
)
from libstacker_tpu.parallel import make_mesh


@pytest.fixture(scope="module")
def mesh4():
    return make_mesh(jax.devices()[:4], data=4, spatial=1)


def _write_burst(d, frames):
    d.mkdir()
    files = []
    for i, f in enumerate(frames):
        p = d / f"f{i:02d}.png"
        Image.fromarray(f).save(p)
        files.append(str(p))
    return files


@pytest.fixture(scope="module")
def ecc_burst_dir(tmp_path_factory):
    rng = np.random.default_rng(11)
    h, w = 128, 160
    base = cv2.GaussianBlur(
        rng.random((h * 2, w * 2)).astype(np.float32), (0, 0), 3.0
    ) * 255.0
    frames = []
    shifts = [(0.0, 0.0)] + [
        (float(rng.uniform(-3, 3)), float(rng.uniform(-3, 3)))
        for _ in range(9)
    ]
    for dx, dy in shifts:
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(
            base, m, (w * 2, h * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([cur] * 3, -1).astype(np.uint8))
    d = tmp_path_factory.mktemp("stream_mesh") / "ecc"
    files = _write_burst(d, frames)
    return files, np.stack(frames)


_ECC_KW = dict(motion_type=MotionType.Translation, max_count=50,
               epsilon=1e-4)


def test_ecc_stream_mesh_matches_dense(ecc_burst_dir, mesh4):
    """Streamed + sharded mean stack == the whole-burst dense pipeline
    (chunk_size rounds up to the data axis; tail chunk rides the
    lane_valid pad path)."""
    files, frames = ecc_burst_dir
    params = EccMatchParameters(**_ECC_KW)
    dense = ecc_match_arrays(frames, params)
    out, stats = ecc_match_stream(
        files, params, chunk_size=3, mesh=mesh4, return_stats=True,
    )  # 3 -> 4 (data axis), 9 lanes -> chunks of 4+4+1
    np.testing.assert_allclose(out, np.asarray(dense), atol=2e-4)
    assert stats.frames_total == 10
    assert stats.frames_kept == 10
    assert len(stats.ecc_rho) == 9


def test_ecc_stream_mesh_sigma_matches_dense(ecc_burst_dir, mesh4):
    """Streamed + sharded sigma-clip == the whole-burst dense sigma
    stack (moment sweeps psum per chunk; documented near-exactness of
    the distributed clip — boundary samples can flip at the last ulp)."""
    files, frames = ecc_burst_dir
    params = EccMatchParameters(
        stacking="sigma_clip", sigma_kappa=2.0, sigma_iters=2, **_ECC_KW
    )
    dense = np.asarray(ecc_match_arrays(frames, params))
    out = ecc_match_stream(files, params, chunk_size=4, mesh=mesh4)
    diff = np.abs(out - dense)
    assert (diff <= 2e-4).mean() > 0.99, (diff <= 2e-4).mean()
    assert diff.max() < 0.05, diff.max()


@pytest.fixture(scope="module")
def kp_burst_dir(tmp_path_factory):
    rng = np.random.default_rng(19)
    h, w = 192, 256
    base = cv2.GaussianBlur(
        rng.integers(0, 256, (h * 2, w * 2), np.uint8), (0, 0), 1.2
    )
    frames = []
    shifts = [(0.0, 0.0)] + [
        (float(rng.uniform(-3, 3)), float(rng.uniform(-3, 3)))
        for _ in range(5)
    ]
    for dx, dy in shifts:
        m = np.array([[1, 0, dx], [0, 1, dy]], np.float32)
        cur = cv2.warpAffine(
            base, m, (w * 2, h * 2),
            flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        )[h // 2 : h // 2 + h, w // 2 : w // 2 + w]
        frames.append(np.stack([cur] * 3, -1).astype(np.uint8))
    d = tmp_path_factory.mktemp("stream_mesh_kp") / "kp"
    files = _write_burst(d, frames)
    return files, np.stack(frames)


def test_keypoint_stream_mesh_matches_dense(kp_burst_dir, mesh4):
    """Streamed + sharded keypoint mean stack vs the whole-burst dense
    pipeline.  RANSAC draws per-lane keys under the mesh (a different
    stream than the dense path), so parity is statistical like
    test_mesh_public_api's keypoint variants."""
    files, frames = kp_burst_dir
    params = KeyPointMatchParameters()
    d_drop, dense = keypoint_match_arrays(frames, params)
    s_drop, out = keypoint_match_stream(
        files, params, chunk_size=8, mesh=mesh4
    )  # 5 lanes -> one padded chunk of 8 (n_loc=2)
    assert s_drop == d_drop
    np.testing.assert_allclose(out, np.asarray(dense), atol=0.06)
    assert np.mean(np.abs(out - np.asarray(dense))) < 5e-3

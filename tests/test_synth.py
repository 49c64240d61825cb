"""Seeded synthetic bursts (libstacker_tpu/utils/synth.py): the true
warps align every frame with frame 0, bursts are reproducible, and the
error measures are right."""

import jax.numpy as jnp
import numpy as np
import pytest

from libstacker_tpu.ops import warp
from libstacker_tpu.utils import synth


@pytest.mark.parametrize("content,tol", [("smooth", 1.0), ("blocks", 8.0)])
def test_true_warps_align_frames(content, tol):
    """Warping frame i forward with its true warp lands on frame 0
    (mean absolute difference in 0..255 levels over the interior; the
    block texture's sharp edges lose more to double resampling)."""
    b = synth.make_burst(4, 96, 160, seed=3, content=content,
                         max_angle=2.0, max_shift=5.0)
    f = np.asarray(b.frames)[..., 0].astype(np.float32)
    assert b.frames.shape == (4, 96, 160, 3)
    np.testing.assert_allclose(b.true_warps[0], np.eye(3))
    for i in range(1, 4):
        al = np.asarray(warp.warp_perspective(
            jnp.asarray(f[i]), jnp.asarray(b.true_warps[i], jnp.float32)
        ))
        d = np.abs(al - f[0])[16:-16, 16:-16]
        assert d.mean() < tol, (i, d.mean())
        # the motion is real: the unaligned frame is further off
        assert np.abs(f[i] - f[0])[16:-16, 16:-16].mean() > 2 * d.mean()


def test_burst_is_seeded_and_truth_reproducible():
    a = synth.make_burst(3, 48, 64, seed=5, noise_sigma=2.0)
    b = synth.make_burst(3, 48, 64, seed=5, noise_sigma=2.0)
    c = synth.make_burst(3, 48, 64, seed=6, noise_sigma=2.0)
    np.testing.assert_array_equal(np.asarray(a.frames), np.asarray(b.frames))
    assert not np.array_equal(np.asarray(a.frames), np.asarray(c.frames))
    np.testing.assert_array_equal(
        a.true_warps, synth.true_warps(3, 48, 64, seed=5)
    )
    np.testing.assert_allclose(
        a.base, np.asarray(synth.make_burst(1, 48, 64, seed=5).frames)[0, ..., 0]
        / 255.0, atol=0.5 / 255.0 + 1e-9,
    )


def test_corner_error_and_psnr():
    truth = np.eye(3)[None]
    est = truth.copy()
    est[0, 0, 2] = 0.5
    np.testing.assert_allclose(
        synth.corner_error(est, truth, 100, 200), [0.5]
    )
    # a 2x3 estimate is promoted; a pure rotation moves the far corner
    rot = np.array([[[np.cos(0.01), -np.sin(0.01), 0.0],
                     [np.sin(0.01), np.cos(0.01), 0.0]]])
    far = np.hypot(199, 99) * 2 * np.sin(0.005)
    np.testing.assert_allclose(
        synth.corner_error(rot, truth, 100, 200), [far], rtol=1e-9
    )
    ref = np.zeros((10, 10))
    img = np.full((10, 10, 3), 0.1)
    assert synth.psnr(img, ref) == pytest.approx(20.0)
    img[0] = 1.0  # outside the 1-px interior
    assert synth.psnr(img, ref, margin=1) == pytest.approx(20.0)
    assert synth.psnr(ref, ref) == float("inf")


def test_bad_content_rejected():
    with pytest.raises(ValueError, match="content"):
        synth.make_burst(2, 32, 32, content="stripes")

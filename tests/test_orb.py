"""ORB detector/descriptor statistical parity vs cv2.ORB (SURVEY.md N4).

Exact keypoint-set equality is not expected (sub-pixel resize and
atan2-vs-fastAtan2 differences shuffle rankings); we assert strong
statistical agreement, which is what the keypoint_match pipeline needs
(SURVEY.md §7 phase 5)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libstacker_tpu.ops import orb


@pytest.fixture(scope="module")
def textured(rng):
    small = rng.integers(0, 256, size=(40, 50), dtype=np.uint8)
    img = cv2.resize(small, (400, 320), interpolation=cv2.INTER_NEAREST)
    return cv2.GaussianBlur(img, (3, 3), 0.8)


def test_orb_keypoints_overlap_cv2(textured):
    feats = orb.orb_detect_and_compute(jnp.asarray(textured))
    valid = np.asarray(feats.valid)
    xy = np.asarray(feats.xy)[valid]
    assert valid.sum() > 200

    cv_orb = cv2.ORB_create()
    cv_kps = cv_orb.detect(textured)
    cv_xy = np.array([k.pt for k in cv_kps])
    # fraction of our keypoints with a cv2 keypoint within 2px
    d = np.linalg.norm(xy[:, None, :] - cv_xy[None, :, :], axis=-1)
    near = (d.min(axis=1) < 2.0).mean()
    assert near > 0.6, f"only {near:.0%} of our keypoints near a cv2 keypoint"


def test_orb_descriptors_match_cv2_at_same_keypoints(textured):
    """Feed OUR keypoint locations to cv2.ORB.compute and compare bits."""
    feats = orb.orb_detect_and_compute(jnp.asarray(textured))
    valid = np.asarray(feats.valid)
    xy = np.asarray(feats.xy)
    ang = np.asarray(feats.angle)
    octv = np.asarray(feats.octave)
    desc = np.asarray(feats.descriptors)

    # only level-0 keypoints: provided-keypoint octaves rescale otherwise
    sel = np.nonzero(valid & (octv == 0))[0][:80]
    assert len(sel) >= 30
    cv_orb = cv2.ORB_create()
    kps = [
        cv2.KeyPoint(float(xy[i, 0]), float(xy[i, 1]), 31.0, float(ang[i]), 0.0, 0)
        for i in sel
    ]
    kps_out, cv_desc = cv_orb.compute(textured, kps)
    assert cv_desc.shape[0] == len(sel)
    ham = np.array(
        [
            np.unpackbits(desc[i] ^ cv_desc[j]).sum()
            for j, i in enumerate(sel)
        ]
    )
    # identical angles + recovered pattern => near-identical descriptors
    assert np.median(ham) <= 8, f"median Hamming {np.median(ham)}"
    assert (ham <= 24).mean() > 0.8


def test_orb_angles_match_cv2(textured):
    """Orientation parity: compare our IC angle with cv2's at shared
    detections (fastAtan2 approximation allows ~0.5 deg)."""
    feats = orb.orb_detect_and_compute(jnp.asarray(textured))
    valid = np.asarray(feats.valid)
    octv = np.asarray(feats.octave)
    xy = np.asarray(feats.xy)
    ang = np.asarray(feats.angle)

    cv_orb = cv2.ORB_create()
    cv_kps = cv_orb.detect(textured)
    cv_map = {}
    for k in cv_kps:
        if k.octave == 0:
            cv_map[(round(k.pt[0]), round(k.pt[1]))] = k.angle
    checked = 0
    diffs = []
    for i in np.nonzero(valid & (octv == 0))[0]:
        key = (round(xy[i, 0]), round(xy[i, 1]))
        if key in cv_map:
            d = abs(ang[i] - cv_map[key]) % 360
            diffs.append(min(d, 360 - d))
            checked += 1
    assert checked >= 20
    assert np.median(diffs) < 0.5, f"median angle diff {np.median(diffs)}"


def test_orb_batched_vmap(textured):
    batch = jnp.stack([jnp.asarray(textured)] * 2)
    feats = jax.vmap(orb.orb_detect_and_compute)(batch)
    assert feats.descriptors.shape[0] == 2
    np.testing.assert_array_equal(
        np.asarray(feats.descriptors[0]), np.asarray(feats.descriptors[1])
    )


def _numpy_patches(img, ys, xs, radius):
    h, w = img.shape
    side = 2 * radius + 1
    y0 = np.clip(ys - radius, 0, h - side)
    x0 = np.clip(xs - radius, 0, w - side)
    offs = np.arange(side)
    return img[
        y0[:, None, None] + offs[None, :, None],
        x0[:, None, None] + offs[None, None, :],
    ]


@pytest.mark.parametrize("radius", [orb.PATCH_RADIUS, orb.BLUR_RADIUS])
def test_extract_patches_interior(radius):
    """Keypoint patches are the image neighbourhoods, exactly."""
    rng = np.random.default_rng(61)
    img = rng.random((97, 131)).astype(np.float32) * 255.0
    ys = rng.integers(31, 97 - 31, 40).astype(np.int32)
    xs = rng.integers(31, 131 - 31, 40).astype(np.int32)
    got = np.asarray(orb.extract_patches(
        jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs), radius=radius
    ))
    np.testing.assert_array_equal(got, _numpy_patches(img, ys, xs, radius))


def test_extract_patches_clamped_edges():
    """Centres nearer than the radius to a border shift the patch
    ORIGIN inward (never a partial patch)."""
    rng = np.random.default_rng(62)
    img = rng.random((97, 131)).astype(np.float32)
    ys = np.asarray([0, 5, 96, 50], np.int32)
    xs = np.asarray([0, 130, 3, 120], np.int32)
    got = np.asarray(orb.extract_patches(
        jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs)
    ))
    np.testing.assert_array_equal(
        got, _numpy_patches(img, ys, xs, orb.PATCH_RADIUS)
    )


def test_extract_patches_vmap():
    """The ORB pipeline vmaps over frames: batched extraction equals
    per-frame extraction."""
    import jax

    rng = np.random.default_rng(63)
    imgs = rng.random((2, 97, 131)).astype(np.float32)
    ys = rng.integers(31, 66, (2, 16)).astype(np.int32)
    xs = rng.integers(31, 100, (2, 16)).astype(np.int32)
    got = np.asarray(jax.vmap(orb.extract_patches)(
        jnp.asarray(imgs), jnp.asarray(ys), jnp.asarray(xs)
    ))
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], _numpy_patches(imgs[i], ys[i], xs[i], orb.PATCH_RADIUS)
        )

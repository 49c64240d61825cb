"""ORB keypoint detection + rBRIEF description, batched and static-shape.

Device counterpart of OpenCV's all-default ``ORB::create_def()``
``detect_and_compute`` (SURVEY.md N4; ref src/utils.rs:174-183 —
nfeatures=500, scaleFactor=1.2, nlevels=8, edgeThreshold=31, WTA_K=2,
HARRIS_SCORE, patchSize=31, fastThreshold=20):

- 8-level INTER_LINEAR pyramid (cascaded resize, cvRound sizes);
- FAST-9 (threshold 20, NMS) per level as a dense vectorised program;
- per-level quotas distributed geometrically like OpenCV, retain-best
  2*n by FAST score then n by Harris response (blockSize 7, k=0.04);
- intensity-centroid orientation over the radius-15 circular patch;
- steered rBRIEF over OpenCV's learned 256-pair pattern (recovered by
  black-box probing, see ops/_orb_pattern.py) on the GaussianBlur(7,7,2)
  level image.

Everything is fixed-capacity with validity masks (JAX static shapes,
SURVEY.md §7 hard part b): output is always [nfeatures] slots.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from . import fast, filters, resize

# Patch radii: 18 covers every DESCRIPTOR consumer — Harris needs +-5
# (7x7 block + Sobel support), the IC angle +-15, and rBRIEF's rotated
# pattern taps +-18 (|pattern| <= 13 -> rotated |offset| <=
# round(13*sqrt(2)) = 18; ORB's edge_threshold 31 keeps all taps
# in-image).  BLUR_RADIUS additionally carries the GaussianBlur(7,
# sigma 2) support, so the PATCHES (a few hundred 43x43 tiles) are
# blurred instead of every full level image — exact, because
# edge_threshold keeps the blur support off the image border.
PATCH_RADIUS = 18
PATCH_SIDE = 2 * PATCH_RADIUS + 1  # 37
BLUR_RADIUS = PATCH_RADIUS + 3


def extract_patches(
    img: jnp.ndarray, ys, xs, radius: int = PATCH_RADIUS
) -> jnp.ndarray:
    """[K, side, side] float32 patches around (ys, xs) by one XLA gather,
    with CLAMPED patch origins (patches of keypoints nearer than
    ``radius`` to a border shift inward; ORB keypoints never are)."""
    side = 2 * radius + 1
    h, w = img.shape
    y0 = jnp.clip(ys - radius, 0, h - side)
    x0 = jnp.clip(xs - radius, 0, w - side)
    offs = jnp.arange(side)
    py = y0[:, None, None] + offs[None, :, None]
    px = x0[:, None, None] + offs[None, None, :]
    return img.astype(jnp.float32)[py, px]


try:
    from ._orb_pattern import ORB_PATTERN
except ImportError:  # pragma: no cover
    # Fallback when the recovered OpenCV pattern is unavailable: the
    # BRIEF-style isotropic Gaussian test pattern (sigma = patch/5,
    # Calonder et al.), fixed seed.  Self-consistent matching still
    # works; only descriptor-level OpenCV interop differs.
    _rng = np.random.default_rng(31)
    ORB_PATTERN = np.clip(
        np.round(_rng.normal(0.0, 31 / 5.0, size=(256, 4))), -13, 13
    ).astype(np.int32)


class OrbFeatures(NamedTuple):
    xy: jnp.ndarray  # [K,2] float32 — (x, y) in ORIGINAL image coords
    response: jnp.ndarray  # [K] float32 (Harris)
    angle: jnp.ndarray  # [K] float32 degrees
    octave: jnp.ndarray  # [K] int32
    size: jnp.ndarray  # [K] float32
    valid: jnp.ndarray  # [K] bool
    descriptors: jnp.ndarray  # [K,32] uint8


def _features_per_level(nfeatures: int, nlevels: int, scale_factor: float):
    """OpenCV's geometric distribution of features over pyramid levels."""
    factor = 1.0 / scale_factor
    ndesired = nfeatures * (1 - factor) / (1 - factor ** nlevels)
    counts = []
    total = 0
    for _ in range(nlevels - 1):
        n = int(round(ndesired))
        counts.append(n)
        total += n
        ndesired *= factor
    counts.append(max(nfeatures - total, 0))
    return counts


@functools.lru_cache(maxsize=1)
def _ic_angle_weights(half_patch: int = 15):
    """Circular-patch masks for the intensity-centroid angle, built with
    OpenCV's umax construction (symmetric quarter-circle table)."""
    umax = [0] * (half_patch + 2)
    vmax = int(math.floor(half_patch * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(half_patch * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(half_patch * half_patch - v * v)))
    v0 = 0
    for v in range(half_patch, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    side = 2 * half_patch + 1
    us = np.arange(-half_patch, half_patch + 1)[None, :]
    vs = np.arange(-half_patch, half_patch + 1)[:, None]
    inside = np.abs(us) <= np.array(
        [umax[abs(int(v))] for v in vs.ravel()]
    ).reshape(side, 1)
    # numpy (not jnp) so the lru_cache never captures a traced value
    wu = (us * inside).astype(np.float32)
    wv = (vs * inside).astype(np.float32)
    return wu, wv


def _ic_angles_from_patches(
    patches: jnp.ndarray, center: int = PATCH_RADIUS
) -> jnp.ndarray:
    """Intensity-centroid orientation (degrees in [0,360)) from
    [K, side, side] keypoint patches (:func:`extract_patches`; the
    radius-15 circular weights sit in the central 31x31 around
    ``center``)."""
    wu, wv = _ic_angle_weights()
    wu, wv = jnp.asarray(wu), jnp.asarray(wv)
    c = center
    sub = patches[:, c - 15 : c + 16, c - 15 : c + 16]
    m10 = jnp.sum(sub * wu, axis=(1, 2))
    m01 = jnp.sum(sub * wv, axis=(1, 2))
    ang = jnp.degrees(jnp.arctan2(m01, m10))
    return jnp.where(ang < 0, ang + 360.0, ang)


def _blur_patches_valid(patches: jnp.ndarray) -> jnp.ndarray:
    """GaussianBlur(7x7, sigma 2) of [K, 43, 43] raw patches, VALID
    mode -> [K, 37, 37]: identical to blurring the whole level image
    and extracting 37x37 (rBRIEF's blur, orb.cpp GaussianBlur before
    computeOrbDescriptors), because ORB's edge_threshold 31 keeps the
    blur support of every tap inside the image — so the border rule
    never engages.  Blurring a few hundred 43x43 patches replaces a
    full-image blur per pyramid level."""
    kern = filters.gaussian_kernel(7, 2.0)
    side = PATCH_SIDE
    rows = None
    for i, kw in enumerate(kern):
        term = kw * patches[:, i : i + side, :]
        rows = term if rows is None else rows + term
    out = None
    for i, kw in enumerate(kern):
        term = kw * rows[:, :, i : i + side]
        out = term if out is None else out + term
    return out


def _rbrief_from_patches(patches: jnp.ndarray, angles_deg) -> jnp.ndarray:
    """Steered rBRIEF bits from [K, 37, 37] blurred-image patches ->
    [K,32] uint8 (LSB-first packing).

    The rotation-dependent taps are resolved with a flat
    ``take_along_axis`` gather per patch: |pattern| <= 13 so every
    rotated offset lies within +-18 = the patch radius (ORB's
    edge_threshold 31 keeps taps in-image, matching OpenCV's unclamped
    GET_VALUE)."""
    pat = jnp.asarray(ORB_PATTERN, dtype=jnp.float32)  # [256,4]
    ang = jnp.deg2rad(angles_deg)
    a = jnp.cos(ang)[:, None]
    b = jnp.sin(ang)[:, None]
    # OpenCV: col off = round(x*a - y*b), row off = round(x*b + y*a)
    px_ = jnp.concatenate([pat[:, 0], pat[:, 2]])  # [512]
    py_ = jnp.concatenate([pat[:, 1], pat[:, 3]])
    c = PATCH_RADIUS
    side = PATCH_SIDE
    rx = jnp.round(px_[None] * a - py_[None] * b).astype(jnp.int32) + c
    ry = jnp.round(px_[None] * b + py_[None] * a).astype(jnp.int32) + c
    flat = patches.reshape(patches.shape[0], -1)  # [K, side*side]
    vals = jnp.take_along_axis(flat, ry * side + rx, axis=1)  # [K,512]
    v1 = vals[:, :256]
    v2 = vals[:, 256:]
    bits = (v1 < v2).astype(jnp.uint8)  # [K,256]
    weights = (2 ** jnp.arange(8, dtype=jnp.uint32)).astype(jnp.uint32)
    bytes_ = jnp.sum(
        bits.reshape(bits.shape[0], 32, 8).astype(jnp.uint32) * weights[None, None, :],
        axis=-1,
    )
    return bytes_.astype(jnp.uint8)


def orb_detect_and_compute(
    img: jnp.ndarray,
    nfeatures: int = 500,
    scale_factor: float = 1.2,
    nlevels: int = 8,
    edge_threshold: int = 31,
    patch_size: int = 31,
    fast_threshold: int = 20,
    mask: Optional[jnp.ndarray] = None,
) -> OrbFeatures:
    """Detect + describe on a single ``[H,W]`` uint8 grayscale image.
    ``vmap`` over a burst for the batched path.

    ``mask`` ([H,W], nonzero = valid) is cv2 ``detectAndCompute``'s
    detection mask.  OpenCV semantics, pinned by black-box probing of
    cv2.ORB on a half-plane mask: the mask pyramid is resized
    SUCCESSIVELY level-to-level with INTER_LINEAR like the image, and
    re-binarised each level so only fully-interior pixels survive
    (orb.cpp's THRESH_TOZERO at 254 — the valid region erodes ~1 px
    per octave); keypoints are filtered AFTER FAST's non-max
    suppression (a masked-out stronger corner still suppresses valid
    neighbours — KeyPointsFilter::runByPixelsMask runs on the NMS
    output)."""
    h, w = img.shape
    quotas = _features_per_level(nfeatures, nlevels, scale_factor)
    # The patch-space rBRIEF blur needs BLUR_RADIUS + 3 = 24 px of
    # interior around every keypoint to be exactly the image-space blur
    # (see _blur_patches_valid); clamp the detection border so smaller
    # user values cannot silently produce off-centre clamped patches.
    # (Documented deviation: OpenCV would detect keypoints closer to
    # the border and sample its padded blur there.)
    edge_threshold = max(edge_threshold, BLUR_RADIUS + 3)

    level_img = img
    level_mask = None
    if mask is not None:
        level_mask = (jnp.asarray(mask) > 0).astype(jnp.float32)
    feats = []
    for level in range(nlevels):
        scale = scale_factor ** level
        if level > 0:
            lh = int(round(h / scale))
            lw = int(round(w / scale))
            level_img = resize.resize(
                level_img, (lh, lw), constants.INTER_LINEAR
            )
            if level_mask is not None:
                level_mask = resize.resize(
                    level_mask, (lh, lw), constants.INTER_LINEAR
                )
                # orb.cpp re-binarises each level at 254 (THRESH_TOZERO):
                # only pixels whose full INTER_LINEAR support was valid
                # survive — uint8 rounding reproduced on the float mask
                level_mask = (
                    jnp.rint(level_mask * 255.0) >= 255.0
                ).astype(jnp.float32)
        lh, lw = level_img.shape
        quota = quotas[level]
        if quota == 0 or lh <= 2 * edge_threshold or lw <= 2 * edge_threshold:
            continue
        det, score = fast.fast_detect(level_img, fast_threshold)
        ys_g = jnp.arange(lh)[:, None]
        xs_g = jnp.arange(lw)[None, :]
        border_ok = (
            (xs_g >= edge_threshold)
            & (xs_g < lw - edge_threshold)
            & (ys_g >= edge_threshold)
            & (ys_g < lh - edge_threshold)
        )
        det = det & border_ok
        if level_mask is not None:
            # after NMS, like KeyPointsFilter::runByPixelsMask
            det = det & (level_mask > 0.5)
        cand = fast.top_k_keypoints(det, score, min(2 * quota, lh * lw))
        # ONE patch gather per candidate at the blur radius: the raw
        # 43x43 patch carries Harris, the IC angle AND the Gaussian
        # support of every rBRIEF tap, so the per-level full-image blur
        # + second extraction disappear; every later stage is
        # static-slice math over the patches
        cand_patches = extract_patches(
            level_img.astype(jnp.float32), cand.ys, cand.xs,
            radius=BLUR_RADIUS,
        )
        br = BLUR_RADIUS
        hsub = cand_patches[:, br - 4 : br + 5, br - 4 : br + 5]
        harris = fast.harris_from_patches(hsub)
        harris = jnp.where(cand.valid, harris, -jnp.inf)
        hval, hidx = jax.lax.top_k(harris, quota)
        kys = cand.ys[hidx]
        kxs = cand.xs[hidx]
        kvalid = jnp.isfinite(hval) & cand.valid[hidx]
        kept_patches = cand_patches[hidx]
        angles = _ic_angles_from_patches(kept_patches, center=br)
        blur_patches = _blur_patches_valid(kept_patches)
        desc = _rbrief_from_patches(blur_patches, angles)
        xy = jnp.stack(
            [kxs.astype(jnp.float32) * scale, kys.astype(jnp.float32) * scale],
            axis=1,
        )
        feats.append(
            OrbFeatures(
                xy=xy,
                response=hval.astype(jnp.float32),
                angle=angles,
                octave=jnp.full((quota,), level, jnp.int32),
                size=jnp.full((quota,), patch_size * scale, jnp.float32),
                valid=kvalid,
                descriptors=desc,
            )
        )

    if not feats:
        # Image too small for any pyramid level (every level fails the
        # 2*edge_threshold size check): return a fixed-capacity
        # all-invalid feature set so downstream matching sees 0 valid
        # keypoints and the pipeline drops the frame, matching OpenCV's
        # empty detect_and_compute on tiny images (the reference has no
        # minimum-size guard on the keypoint path — src/lib.rs:377-382
        # checks only scale >= width).
        k = 8
        return OrbFeatures(
            xy=jnp.zeros((k, 2), jnp.float32),
            response=jnp.zeros((k,), jnp.float32),
            angle=jnp.zeros((k,), jnp.float32),
            octave=jnp.zeros((k,), jnp.int32),
            size=jnp.zeros((k,), jnp.float32),
            valid=jnp.zeros((k,), bool),
            descriptors=jnp.zeros((k, 32), jnp.uint8),
        )
    return OrbFeatures(
        xy=jnp.concatenate([f.xy for f in feats]),
        response=jnp.concatenate([f.response for f in feats]),
        angle=jnp.concatenate([f.angle for f in feats]),
        octave=jnp.concatenate([f.octave for f in feats]),
        size=jnp.concatenate([f.size for f in feats]),
        valid=jnp.concatenate([f.valid for f in feats]),
        descriptors=jnp.concatenate([f.descriptors for f in feats]),
    )

"""Seeded synthetic bursts with known ground-truth warps.

Every frame is the same padded base image, inverse-mapped by a small
rotation about the image centre plus a shift (the motion of a handheld
or tracking burst), cropped to the frame grid and rounded to uint8.
The base is built with numpy/scipy and the frames are resampled with
the library's own XLA warp, so a burst needs neither OpenCV nor PIL.

Two contents:

- ``"smooth"``: uniform noise blurred with sigma 6 and stretched to
  0..255 (ECC's test content);
- ``"blocks"``: 8x8-pixel random blocks lightly blurred (corners for
  the ORB detector; keypoint test content).

``true_warps`` are in the ECC convention of the pipelines: ``M[i]``
maps a pixel of frame ``i`` (the template) to the matching pixel of
frame 0 (the input), ``frame_i(x) ~ frame_0(M[i] x)``, and stacking
warps frame ``i`` forward with ``M[i]``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

PAD = 32


class Burst(NamedTuple):
    frames: object  # [N,H,W,3] uint8 (jax.Array on the default device)
    true_warps: np.ndarray  # [N,3,3] float64, frame i -> frame 0
    base: np.ndarray  # [H,W] float64 in [0,1]: frame 0's noise-free truth


def _base_image(h: int, w: int, content: str, rng) -> np.ndarray:
    from scipy import ndimage

    hp, wp = h + 2 * PAD, w + 2 * PAD
    if content == "smooth":
        raw = rng.integers(0, 256, size=(hp, wp)).astype(np.float32)
        base = ndimage.gaussian_filter(raw, 6.0, mode="mirror")
        lo, hi = float(base.min()), float(base.max())
        return (base - lo) * (255.0 / max(hi - lo, 1e-6))
    if content == "blocks":
        small = rng.integers(0, 256, size=(-(-hp // 8), -(-wp // 8)))
        base = np.repeat(np.repeat(small, 8, axis=0), 8, axis=1)[:hp, :wp]
        return ndimage.gaussian_filter(
            base.astype(np.float32), 0.8, mode="mirror", truncate=1.25
        )
    raise ValueError(f"content must be 'smooth' or 'blocks', got {content!r}")


def _rotation_about_centre(angle_deg: float, cx: float, cy: float):
    """cv2.getRotationMatrix2D(centre, angle, 1) as a 3x3 matrix."""
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    return np.array(
        [[c, s, (1 - c) * cx - s * cy],
         [-s, c, s * cx + (1 - c) * cy],
         [0.0, 0.0, 1.0]]
    )


def true_warps(n: int, h: int, w: int, seed: int = 0,
               max_angle: float = 0.6, max_shift: float = 6.0) -> np.ndarray:
    """[N,3,3] ground-truth ECC warps of :func:`make_burst` (frame 0 is
    the identity)."""
    return _motion(n, h, w, np.random.default_rng([seed, 1]), max_angle,
                   max_shift)[1]


def _motion(n, h, w, rng, max_angle, max_shift):
    """Per-frame inverse maps on the padded base (``gen``) and the
    ECC-convention truth (``ecc``), from the burst's motion stream."""
    t_pad = np.array([[1.0, 0, PAD], [0, 1.0, PAD], [0, 0, 1.0]])
    t_unpad = np.linalg.inv(t_pad)
    gen = np.tile(np.eye(3), (n, 1, 1))
    for i in range(1, n):
        dx, dy = rng.uniform(-max_shift, max_shift, 2)
        ang = rng.uniform(-max_angle, max_angle)
        m = _rotation_about_centre(ang, w / 2, h / 2)
        m[0, 2] += dx
        m[1, 2] += dy
        gen[i] = m
    # frame_i(x) = base(gen_i (x + pad)) and frame_0(y) = base(y + pad)
    ecc = t_unpad[None] @ gen @ t_pad[None]
    return gen @ t_pad[None], ecc


@functools.lru_cache(maxsize=None)
def _render_fn(h: int, w: int):
    import jax
    import jax.numpy as jnp

    from ..ops import warp

    @jax.jit
    def render(base, mats, noise):
        def one(m, nz):
            v = warp.warp_affine(base, m[:2], (h, w), inverse_map=True)
            return jnp.clip(jnp.round(v + nz), 0, 255).astype(jnp.uint8)

        grey = jax.vmap(one)(mats, noise)
        return jnp.broadcast_to(grey[..., None], grey.shape + (3,))

    return render


def make_burst(n: int, h: int, w: int, seed: int = 0,
               content: str = "smooth", noise_sigma: float = 0.0,
               max_angle: float = 0.6, max_shift: float = 6.0,
               chunk: int = 8) -> Burst:
    """Seeded burst of ``n`` grey frames (replicated to RGB) of ``h`` x
    ``w`` pixels, rendered on the default device in chunks of
    ``chunk`` frames.  ``noise_sigma`` adds per-frame Gaussian noise in
    0..255 levels.  Returns the frames, the true warps and frame 0's
    noise-free content."""
    import jax
    import jax.numpy as jnp

    base = _base_image(h, w, content, np.random.default_rng([seed, 0]))
    gen, ecc = _motion(n, h, w, np.random.default_rng([seed, 1]),
                       max_angle, max_shift)
    base_j = jnp.asarray(base, jnp.float32)
    render = _render_fn(h, w)
    key = jax.random.PRNGKey(seed)
    parts = []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        if noise_sigma > 0:
            nz = noise_sigma * jax.random.normal(
                jax.random.fold_in(key, s), (e - s, h, w), jnp.float32
            )
        else:
            nz = jnp.zeros((e - s, 1, 1), jnp.float32)
        parts.append(render(base_j, jnp.asarray(gen[s:e], jnp.float32), nz))
    frames = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    truth = base[PAD:PAD + h, PAD:PAD + w] / 255.0
    return Burst(frames=frames, true_warps=ecc, base=truth)


def corner_error(est: np.ndarray, truth: np.ndarray, h: int, w: int):
    """[N] largest displacement (px) between the image corners mapped
    by the estimated and the true warps (2x3 or 3x3 each)."""
    def as3(m):
        m = np.asarray(m, np.float64)
        if m.shape[-2] == 2:
            bottom = np.broadcast_to([0.0, 0.0, 1.0], m.shape[:-2] + (1, 3))
            m = np.concatenate([m, bottom], axis=-2)
        return m

    corners = np.array(
        [[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]],
        np.float64,
    ).T
    pe = as3(est) @ corners
    pt = as3(truth) @ corners
    pe = pe[:, :2] / pe[:, 2:]
    pt = pt[:, :2] / pt[:, 2:]
    return np.max(np.linalg.norm(pe - pt, axis=1), axis=-1)


def psnr(img: np.ndarray, ref: np.ndarray, margin: int = 0) -> float:
    """PSNR (dB, peak 1.0) of ``img`` against ``ref`` over the interior
    that leaves ``margin`` pixels at every edge; ``img`` may carry a
    trailing channel axis, compared channel by channel."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    if img.ndim == ref.ndim + 1:
        ref = ref[..., None]
    sl = (slice(margin, img.shape[0] - margin),
          slice(margin, img.shape[1] - margin))
    mse = float(np.mean((img[sl] - ref[sl]) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(1.0 / mse)

"""Batched phase correlation — translation init for the ECC solver.

A capability beyond the reference (libstacker always starts
findTransformECC from the identity, src/lib.rs:769-777): one batched
FFT cross-power pass recovers every frame's global translation to
sub-pixel accuracy, and the Gauss-Newton solve starts from there —
same converged warp (the init only moves the start point inside the
same basin), a fraction of the iterations when the burst has real
pixel-scale shifts.

Device notes: everything is jittable (``jnp.fft`` lowers to XLA FFT), one
program for the whole burst, and the correlation peak is located with
``argmax`` + a 3-point parabolic refinement — no host round-trip.

Math (matching cv2::phaseCorrelate, modules/imgproc/src/phasecorr.cpp):
for ``a(x) = b(x + t)`` the normalised cross-power spectrum of
``(A, B)`` is ``exp(2πi k·t)`` whose inverse FFT peaks at ``-t``
(wrapped).  With ECC's convention (template = current frame, input =
frame 0, ``template(x) ≈ input(W x)``) the warp translation is ``t``
with ``a = template`` and ``b = input``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..params import MotionType
from . import ecc as ecc_ops

# peak response below this is noise (uncorrelated content / flat
# frames): keep the identity init instead of a garbage shift.  Measured:
# genuinely aligned burst frames score 0.3-0.99; smooth uncorrelated
# noise scores ~0.03.
_MIN_RESPONSE = 0.05


def _hann2d(h: int, w: int) -> jnp.ndarray:
    """Separable Hann window (cv2 createHanningWindow semantics)."""
    wy = 0.5 - 0.5 * jnp.cos(
        2.0 * jnp.pi * jnp.arange(h, dtype=jnp.float32) / (h - 1)
    )
    wx = 0.5 - 0.5 * jnp.cos(
        2.0 * jnp.pi * jnp.arange(w, dtype=jnp.float32) / (w - 1)
    )
    return wy[:, None] * wx[None, :]


def _parabolic(c_m1, c_0, c_p1):
    """3-point parabola vertex offset in [-0.5, 0.5]."""
    den = c_m1 - 2.0 * c_0 + c_p1
    off = jnp.where(
        jnp.abs(den) > 1e-12, 0.5 * (c_m1 - c_p1) / den, 0.0
    )
    return jnp.clip(off, -0.5, 0.5)


def _auto_downscale(h: int, w: int) -> int:
    """Smallest power-of-2 pooling factor that brings the correlation
    grid under ~0.6 Mpx (a 4K burst pools 4x: the FFT temporaries of a
    full-res [N,2160,3840] complex cross-power spectrum exceed HBM for
    ~100-lane bursts, and a quarter-res init is still within ~1 px —
    one extra Gauss-Newton iteration at most)."""
    d = 1
    while (h // d) * (w // d) > 600_000 and min(h, w) // (2 * d) >= 64:
        d *= 2
    return d


def _pool(x: jnp.ndarray, d: int) -> jnp.ndarray:
    """d x d average pooling (exact area downsample; trailing rows/cols
    beyond a multiple of d are cropped — irrelevant for correlation)."""
    if d == 1:
        return x
    h, w = x.shape[-2], x.shape[-1]
    hc, wc = (h // d) * d, (w // d) * d
    x = x[..., :hc, :wc]
    x = x.reshape(*x.shape[:-2], hc // d, d, wc // d, d)
    return x.mean(axis=(-3, -1))


@functools.partial(jax.jit, static_argnames=("window", "downscale"))
def phase_correlate_batched(
    templates: jnp.ndarray,  # [N,H,W] float32 (current frames' grey)
    input_image: jnp.ndarray,  # [H,W] float32 (reference grey)
    window: bool = True,
    downscale: int = 1,
):
    """Per-frame translation ``t`` such that
    ``templates[i](x) ≈ input_image(x + t_i)`` — i.e. the translation
    part of the ECC warp (template -> input coords).

    Returns ``(t, response)``: ``t`` is ``[N,2]`` float32 ``(tx, ty)``
    in FULL-resolution pixels, ``response`` is the normalised
    correlation peak height ``[N]`` (compare against
    :data:`_MIN_RESPONSE`).  ``downscale`` pools the grid ``d x d``
    before the FFT (bounds the complex temporaries; the recovered shift
    is scaled back up).
    """
    n = templates.shape[0]
    a = _pool(templates.astype(jnp.float32), downscale)
    b = _pool(input_image.astype(jnp.float32), downscale)
    h, w = a.shape[-2], a.shape[-1]
    if window:
        win = _hann2d(h, w)
        a = a * win
        b = b * win
    fa = jnp.fft.rfft2(a)
    fb = jnp.fft.rfft2(b)
    cross = fa * jnp.conj(fb)[None]
    cross = cross / jnp.maximum(jnp.abs(cross), 1e-12)
    r = jnp.fft.irfft2(cross, s=(h, w))  # [N,H,W], peak at -t (wrapped)

    flat = r.reshape(n, h * w)
    idx = jnp.argmax(flat, axis=1)
    py = idx // w
    px = idx % w
    resp = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]

    def at(dy, dx):
        yy = jnp.mod(py + dy, h)
        xx = jnp.mod(px + dx, w)
        return jnp.take_along_axis(
            flat, (yy * w + xx)[:, None], axis=1
        )[:, 0]

    sub_y = _parabolic(at(-1, 0), resp, at(1, 0))
    sub_x = _parabolic(at(0, -1), resp, at(0, 1))
    # unwrap: peak position p in [0, N) encodes -t; shifts beyond half
    # the extent alias (inherent to cyclic correlation)
    fy = py.astype(jnp.float32) + sub_y
    fx = px.astype(jnp.float32) + sub_x
    ty = -jnp.where(fy > h / 2.0, fy - h, fy) * downscale
    tx = -jnp.where(fx > w / 2.0, fx - w, fx) * downscale
    return jnp.stack([tx, ty], axis=1), resp


def _bilinear_sample(img: jnp.ndarray, ys: jnp.ndarray, xs: jnp.ndarray):
    """Bilinear sample ``img`` [H,W] at float coords (zero outside).
    Small sample sets only (the log-polar grids are a few tens of
    thousands of points — XLA gathers are fine at this size)."""
    h, w = img.shape
    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    fy = ys - y0
    fx = xs - x0
    y0i = y0.astype(jnp.int32)
    x0i = x0.astype(jnp.int32)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = img[jnp.clip(yy, 0, h - 1), jnp.clip(xx, 0, w - 1)]
        return jnp.where(ok, v, 0.0)

    return (
        tap(y0i, x0i) * (1 - fy) * (1 - fx)
        + tap(y0i, x0i + 1) * (1 - fy) * fx
        + tap(y0i + 1, x0i) * fy * (1 - fx)
        + tap(y0i + 1, x0i + 1) * fy * fx
    )


def _logpolar_magnitude(
    x: jnp.ndarray, n_theta: int, n_rho: int
) -> jnp.ndarray:
    """High-pass-filtered FFT magnitude of ``x`` [H,W] resampled onto a
    (theta, log-rho) grid — the Reddy-Chatterji transform (IEEE TIP
    1996): rotation of the image becomes a cyclic shift along theta,
    uniform scaling a shift along log-rho.  Theta spans [0, pi) (the
    magnitude spectrum is pi-periodic)."""
    h, w = x.shape
    f = jnp.abs(jnp.fft.fftshift(jnp.fft.fft2(x)))
    # Reddy-Chatterji high-pass: kills the DC blob that otherwise
    # dominates the correlation
    fy = (jnp.arange(h, dtype=jnp.float32) - h // 2) / h
    fx = (jnp.arange(w, dtype=jnp.float32) - w // 2) / w
    cc = jnp.cos(jnp.pi * fy)[:, None] * jnp.cos(jnp.pi * fx)[None, :]
    f = f * (1.0 - cc) * (2.0 - cc)
    cy, cx = h // 2, w // 2
    rho_max = min(h, w) / 2.0 - 1.0
    rho_min = 1.0
    base = (rho_max / rho_min) ** (1.0 / (n_rho - 1))
    rs = rho_min * base ** jnp.arange(n_rho, dtype=jnp.float32)
    ths = jnp.pi * jnp.arange(n_theta, dtype=jnp.float32) / n_theta
    ys = cy + rs[None, :] * jnp.sin(ths)[:, None]  # [n_theta, n_rho]
    xs = cx + rs[None, :] * jnp.cos(ths)[:, None]
    return _bilinear_sample(f, ys, xs)


@functools.partial(
    jax.jit, static_argnames=("downscale", "n_theta", "n_rho")
)
def phase_correlate_rotscale(
    templates: jnp.ndarray,  # [N,H,W] float32
    input_image: jnp.ndarray,  # [H,W] float32
    downscale: int = 1,
    n_theta: int = 180,
    n_rho: int = 128,
):
    """Per-frame (rotation, scale) of the linear part of the ECC warp
    (``template(x) ≈ input(W x)``, W = scale * R(theta) about the image
    centre composed with a translation) via log-polar phase correlation
    of the FFT magnitudes (Reddy-Chatterji — translation-invariant, so
    it decouples from the shift).

    Returns ``(theta, scale, response)``: ``theta`` [N] radians in
    (-pi/2, pi/2] (the magnitude spectrum is pi-periodic, so rotations
    are recovered modulo pi — fine for burst alignment), ``scale`` [N],
    ``response`` [N] normalised correlation peak height."""
    n = templates.shape[0]
    a = _pool(templates.astype(jnp.float32), downscale)
    b = _pool(input_image.astype(jnp.float32), downscale)
    h, w = a.shape[-2], a.shape[-1]
    win = _hann2d(h, w)
    lp_a = jax.vmap(
        lambda im: _logpolar_magnitude(im * win, n_theta, n_rho)
    )(a)
    lp_b = _logpolar_magnitude(b * win, n_theta, n_rho)
    # the theta axis is genuinely cyclic (pi-periodic magnitude), but
    # log-rho is NOT: window it so the cyclic cross-correlation's
    # wrap-around does not bias the scale peak
    wr = 0.5 - 0.5 * jnp.cos(
        2.0 * jnp.pi * jnp.arange(n_rho, dtype=jnp.float32) / (n_rho - 1)
    )
    lp_a = lp_a * wr[None, None, :]
    lp_b = lp_b * wr[None, :]

    fa = jnp.fft.rfft2(lp_a)
    fb = jnp.fft.rfft2(lp_b)
    cross = fa * jnp.conj(fb)[None]
    cross = cross / jnp.maximum(jnp.abs(cross), 1e-12)
    r = jnp.fft.irfft2(cross, s=(n_theta, n_rho))

    flat = r.reshape(n, n_theta * n_rho)
    idx = jnp.argmax(flat, axis=1)
    pt = idx // n_rho
    pr = idx % n_rho
    resp = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]

    def at(dt, dr):
        tt = jnp.mod(pt + dt, n_theta)
        rr = jnp.mod(pr + dr, n_rho)
        return jnp.take_along_axis(
            flat, (tt * n_rho + rr)[:, None], axis=1
        )[:, 0]

    sub_t = _parabolic(at(-1, 0), resp, at(1, 0))
    sub_r = _parabolic(at(0, -1), resp, at(0, 1))
    ft = pt.astype(jnp.float32) + sub_t
    fr = pr.astype(jnp.float32) + sub_r
    # peak at position p encodes a cyclic shift of -delta: unwrap both
    # axes about zero (theta is pi-periodic; log-rho is not cyclic but
    # burst scale changes are tiny, so the near-zero representative is
    # the right one)
    dth_bins = -jnp.where(ft > n_theta / 2.0, ft - n_theta, ft)
    drho_bins = -jnp.where(fr > n_rho / 2.0, fr - n_rho, fr)
    rho_max = min(h, w) / 2.0 - 1.0
    base = rho_max ** (1.0 / (n_rho - 1))
    # Fourier geometry: rotating the image rotates |F| the SAME way
    # (A^-T = R for orthogonal A), but scaling the image by s scales
    # |F| by 1/s (reciprocal lattice) — hence the sign flip on the
    # log-rho axis only.  Signs pinned against ground-truth cv2 warps
    # in tests/test_phasecorr.py.
    theta = dth_bins * (jnp.pi / n_theta)
    scale = base ** (-drho_bins)
    # wrap theta to (-pi/2, pi/2]
    theta = jnp.where(theta > jnp.pi / 2, theta - jnp.pi, theta)
    theta = jnp.where(theta <= -jnp.pi / 2, theta + jnp.pi, theta)
    return theta, scale, resp


# rotation/scale init gates: below-threshold log-polar responses or
# implausible burst-scale changes keep the translation-only init.
# Measured: genuinely rotated/scaled pairs score 0.25-0.5; heavy-noise
# pairs whose estimates are garbage score 0.04-0.05; uncorrelated
# content ~0.01-0.03.  A garbage rotation init is WORSE than identity,
# so the gate sits well above the noise band.
_MIN_RS_RESPONSE = 0.10
_MAX_LOG_SCALE = 0.35  # ~1.4x — far beyond any handheld burst


@functools.partial(
    jax.jit, static_argnames=("motion_type", "window", "rotation")
)
def phase_init_warps(
    templates: jnp.ndarray,  # [N,H,W] float32
    input_image: jnp.ndarray,  # [H,W] float32
    motion_type: MotionType = MotionType.Affine,
    window: bool = True,
    rotation: bool = False,
) -> jnp.ndarray:
    """Identity warps with the phase-correlation translation filled in,
    shaped for :func:`ops.ecc.find_transform_ecc_batched`'s
    ``warp_init`` ([N,2,3] or [N,3,3] for Homography).  Low-response
    lanes keep the pure identity (the solver's default start).

    ``rotation=True`` additionally recovers each frame's rotation (and,
    for Affine/Homography, uniform scale) via log-polar magnitude
    correlation BEFORE the translation pass — the translation is then
    measured on the de-rotated template, and the init composes
    ``W = T(t) @ A_c`` (A_c = scale*R(theta) about the image centre).
    This starts the Gauss-Newton solve inside the convergence basin for
    bursts with real rotation, where an identity/translation init can
    diverge (cv2.findTransformECC aborts on such pairs)."""
    n, h, w = templates.shape
    ds = _auto_downscale(h, w)
    if not rotation or motion_type == MotionType.Translation:
        t, resp = phase_correlate_batched(
            templates, input_image, window=window, downscale=ds,
        )
        good = (resp >= _MIN_RESPONSE) & jnp.all(jnp.isfinite(t), axis=1)
        t = jnp.where(good[:, None], t, 0.0)
        eye = ecc_ops.identity_warp(motion_type)
        init = jnp.tile(eye[None], (n, 1, 1))
        init = init.at[:, 0, 2].set(t[:, 0]).at[:, 1, 2].set(t[:, 1])
        return init

    theta, scale, resp_rs = phase_correlate_rotscale(
        templates, input_image, downscale=ds,
    )
    if motion_type == MotionType.Euclidean:
        scale = jnp.ones_like(scale)  # rigid motion cannot scale
    good_rs = (
        (resp_rs >= _MIN_RS_RESPONSE)
        & jnp.isfinite(theta)
        & jnp.isfinite(scale)
        & (jnp.abs(jnp.log(jnp.maximum(scale, 1e-6))) <= _MAX_LOG_SCALE)
    )
    theta = jnp.where(good_rs, theta, 0.0)
    scale = jnp.where(good_rs, scale, 1.0)

    # A_c = scale * R(theta) about the image centre, in W's inverse-map
    # convention (template grid -> input coords)
    c, s = jnp.cos(theta), jnp.sin(theta)
    a00 = scale * c
    a01 = -scale * s
    a10 = scale * s
    a11 = scale * c
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    atx = cx - (a00 * cx + a01 * cy)
    aty = cy - (a10 * cx + a11 * cy)

    # translation pass on the DE-ROTATED templates (pool first: the
    # de-rotation warp and the FFT both run on the small grid)
    tp = _pool(templates.astype(jnp.float32), ds)
    ip = _pool(input_image.astype(jnp.float32), ds)
    ph, pw = tp.shape[-2], tp.shape[-1]
    pcx, pcy = (pw - 1) / 2.0, (ph - 1) / 2.0
    # sample template at A_c_pooled @ x: tp_d(x) = tp(A x) cancels the
    # rotation/scale, leaving a pure shift vs the input
    yy = jnp.arange(ph, dtype=jnp.float32)[:, None] * jnp.ones((1, pw))
    xx = jnp.arange(pw, dtype=jnp.float32)[None, :] * jnp.ones((ph, 1))
    # undo the estimated linear part: tp_d(x) = tp(A_c^-1 x), so
    # tp_d(x) = input(A_c A_c^-1 x + t) = input(x + t) — a pure shift
    det = a00 * a11 - a01 * a10
    i00, i01 = a11 / det, -a01 / det
    i10, i11 = -a10 / det, a00 / det

    def derot(im, i):
        sx = i00[i] * (xx - pcx) + i01[i] * (yy - pcy) + pcx
        sy = i10[i] * (xx - pcx) + i11[i] * (yy - pcy) + pcy
        return _bilinear_sample(im, sy, sx)

    tp_d = jax.vmap(derot)(tp, jnp.arange(n))
    t, resp = phase_correlate_batched(tp_d, ip, window=window, downscale=1)
    t = t * ds
    good = (resp >= _MIN_RESPONSE) & jnp.all(jnp.isfinite(t), axis=1)
    t = jnp.where(good[:, None], t, 0.0)

    # W = T(t) @ A_c:  template(x) = tp_d_full(A_c x) ≈ input(A_c x + t)
    eye = ecc_ops.identity_warp(motion_type)
    init = jnp.tile(eye[None], (n, 1, 1))
    init = init.at[:, 0, 0].set(a00).at[:, 0, 1].set(a01)
    init = init.at[:, 1, 0].set(a10).at[:, 1, 1].set(a11)
    init = init.at[:, 0, 2].set(atx + t[:, 0])
    init = init.at[:, 1, 2].set(aty + t[:, 1])
    return init

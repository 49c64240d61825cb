"""Vectorised RANSAC / LMEDS homography estimation.

Device counterpart of ``calib3d::find_homography`` (SURVEY.md N3;
call sites ref src/lib.rs:267-276, 504-513).  OpenCV runs a sequential
adaptive RANSAC loop (up to ``maxIters``=2000 with confidence-based
early exit); here hypotheses are generated in fixed-size SLABS — each
slab is a batched 4-point DLT (one 8x8 solve per hypothesis) scored
against every correspondence at once — inside a ``lax.while_loop``
whose trip count follows OpenCV's ``RANSACUpdateNumIters`` rule: stop
once enough hypotheses were drawn that, at the observed inlier ratio,
an all-inlier sample was seen with probability ``confidence``.  High
inlier ratios exit after one slab; low ratios escalate to the full
``max_iters`` budget like OpenCV does.  Degenerate samples (repeated
indices, 3-of-4 collinear points — OpenCV's ``checkSubset``) are
rejected.  A masked Gauss-Newton polish on the inlier set mirrors
OpenCV's final LM refinement.

RANSAC is randomised in OpenCV too, so parity is statistical: tests
assert reprojection-error quality and inlier-count ranges rather than
bitwise H equality (SURVEY.md §7 phase 5).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants

_HIGHEST = jax.lax.Precision.HIGHEST


def _denormalise(t_dst_inv, h, t_src):
    """``t_dst_inv @ h @ t_src`` in full f32 (no TF32 rounding)."""
    return jnp.matmul(
        jnp.matmul(t_dst_inv, h, precision=_HIGHEST), t_src,
        precision=_HIGHEST,
    )


_BIG = np.float32(1e18)  # numpy scalar: no backend init at import


class HomographyResult(NamedTuple):
    h: jnp.ndarray  # [3,3] float32, maps src -> dst, h[2,2]=1
    inliers: jnp.ndarray  # [M] bool
    num_inliers: jnp.ndarray  # [] int32
    ok: jnp.ndarray  # [] bool


def _normalise_points(pts: jnp.ndarray, valid: jnp.ndarray):
    """Hartley normalisation: translate to centroid, scale mean distance
    to sqrt(2).  Returns (pts_norm, T) with pts_norm = T @ [pts,1]."""
    w = valid.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w[:, None], axis=0) / n
    d = jnp.sqrt(jnp.sum((pts - mean) ** 2, axis=1) + 1e-12)
    mean_d = jnp.sum(d * w) / n
    s = jnp.sqrt(2.0) / jnp.maximum(mean_d, 1e-6)
    t = jnp.array(
        [[s, 0.0, -s * mean[0]], [0.0, s, -s * mean[1]], [0.0, 0.0, 1.0]],
        dtype=jnp.float32,
    )
    pn = (pts - mean) * s
    return pn, t


def _solve_h_4pt(src4: jnp.ndarray, dst4: jnp.ndarray) -> jnp.ndarray:
    """Exact DLT from 4 correspondences: solve the 8x8 system for
    h = [h00..h21], h22 = 1.  src4/dst4: [4,2]."""
    x, y = src4[:, 0], src4[:, 1]
    u, v = dst4[:, 0], dst4[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    rows_u = jnp.stack([x, y, o, z, z, z, -u * x, -u * y], axis=1)
    rows_v = jnp.stack([z, z, z, x, y, o, -v * x, -v * y], axis=1)
    a = jnp.concatenate([rows_u, rows_v], axis=0)  # [8,8]
    b = jnp.concatenate([u, v], axis=0)  # [8]
    h8 = jnp.linalg.solve(a, b)
    h = jnp.concatenate([h8, jnp.ones((1,), h8.dtype)]).reshape(3, 3)
    return h


def _project(h: jnp.ndarray, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply homography to [M,2] points."""
    x, y = pts[:, 0], pts[:, 1]
    w = h[2, 0] * x + h[2, 1] * y + h[2, 2]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    u = (h[0, 0] * x + h[0, 1] * y + h[0, 2]) / w
    v = (h[1, 0] * x + h[1, 1] * y + h[1, 2]) / w
    return jnp.stack([u, v], axis=1)


def _sq_reproj_error(h, src, dst):
    p = _project(h, src)
    return jnp.sum((p - dst) ** 2, axis=1)


def _dlt_least_squares(src, dst, weights):
    """Weighted DLT: smallest eigenvector of A^T A (9x9)."""
    x, y = src[:, 0], src[:, 1]
    u, v = dst[:, 0], dst[:, 1]
    z = jnp.zeros_like(x)
    o = jnp.ones_like(x)
    rows_u = jnp.stack([x, y, o, z, z, z, -u * x, -u * y, -u], axis=1)
    rows_v = jnp.stack([z, z, z, x, y, o, -v * x, -v * y, -v], axis=1)
    a = jnp.concatenate([rows_u * weights[:, None], rows_v * weights[:, None]])
    ata = jnp.matmul(a.T, a, precision=_HIGHEST)
    evals, evecs = jnp.linalg.eigh(ata)
    hvec = evecs[:, 0]
    h = hvec.reshape(3, 3)
    return h / jnp.where(jnp.abs(h[2, 2]) < 1e-12, 1e-12, h[2, 2])


def _gauss_newton_refine(h, src, dst, weights, iters: int = 10):
    """Masked Gauss-Newton on the reprojection error, OpenCV's LM-refine
    counterpart.  Parameterised by the 8 non-h22 entries."""

    def step(h, _):
        x, y = src[:, 0], src[:, 1]
        w = h[2, 0] * x + h[2, 1] * y + h[2, 2]
        w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
        u = (h[0, 0] * x + h[0, 1] * y + h[0, 2]) / w
        v = (h[1, 0] * x + h[1, 1] * y + h[1, 2]) / w
        iw = 1.0 / w
        # d(u)/dparams, d(v)/dparams for params [h00,h01,h02,h10,h11,h12,h20,h21]
        z = jnp.zeros_like(x)
        ju = jnp.stack(
            [x * iw, y * iw, iw, z, z, z, -u * x * iw, -u * y * iw], axis=1
        )
        jv = jnp.stack(
            [z, z, z, x * iw, y * iw, iw, -v * x * iw, -v * y * iw], axis=1
        )
        ru = (u - dst[:, 0]) * weights
        rv = (v - dst[:, 1]) * weights
        jmat = jnp.concatenate([ju * weights[:, None], jv * weights[:, None]])
        r = jnp.concatenate([ru, rv])
        jtj = jnp.matmul(jmat.T, jmat, precision=_HIGHEST)
        jtr = jnp.matmul(jmat.T, r, precision=_HIGHEST)
        damp = 1e-6 * jnp.eye(8, dtype=h.dtype)
        dp = jnp.linalg.solve(jtj + damp, jtr)
        dp = jnp.where(jnp.isfinite(dp), dp, 0.0)
        h_new = h - jnp.concatenate([dp, jnp.zeros((1,), h.dtype)]).reshape(3, 3)
        # keep the update only if it reduces the weighted SSE
        sse_old = jnp.sum(weights * _sq_reproj_error(h, src, dst))
        sse_new = jnp.sum(weights * _sq_reproj_error(h_new, src, dst))
        h = jnp.where(sse_new < sse_old, h_new, h)
        return h, None

    h, _ = jax.lax.scan(step, h, None, length=iters)
    return h


# hypotheses per adaptive-loop slab: one batched DLT solve + one scoring
# matmul per slab; high inlier ratios terminate after a single slab
_SLAB = 128
_FLT_EPS = np.float32(1.1920929e-07)


def _sample_ok(samp, src_pts, dst_pts, count):
    """OpenCV getSubset/checkSubset: distinct indices and no 3 collinear
    points in EITHER point set (calib3d ptsetreg.cpp)."""

    def distinct(q):
        a, b, c, d = q[0], q[1], q[2], q[3]
        return (
            (a != b) & (a != c) & (a != d) & (b != c) & (b != d) & (c != d)
        )

    def non_collinear(idx, pts):
        p = pts[idx]  # [4,2]
        ok = jnp.bool_(True)
        for i, j, kk in ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)):
            d1 = p[j] - p[i]
            d2 = p[kk] - p[i]
            cross = d1[0] * d2[1] - d1[1] * d2[0]
            lim = _FLT_EPS * (jnp.abs(d1[0]) + jnp.abs(d1[1])) * (
                jnp.abs(d2[0]) + jnp.abs(d2[1])
            )
            ok = ok & (jnp.abs(cross) > lim)
        return ok

    ok = jax.vmap(distinct)(samp) & (count >= 4)
    ok = ok & jax.vmap(lambda q: non_collinear(q, src_pts))(samp)
    ok = ok & jax.vmap(lambda q: non_collinear(q, dst_pts))(samp)
    return ok


@functools.partial(
    jax.jit,
    static_argnames=("method", "max_iters", "refine_iters"),
)
def find_homography(
    src_pts: jnp.ndarray,
    dst_pts: jnp.ndarray,
    valid: jnp.ndarray,
    key: jax.Array,
    method: int = constants.RANSAC,
    reproj_threshold: float = 3.0,
    max_iters: int = 2000,
    confidence: float = 0.995,
    refine_iters: int = 10,
) -> HomographyResult:
    """Estimate H mapping src -> dst from padded correspondences.

    ``src_pts``/``dst_pts``: [M,2] float32 with ``valid`` [M] bool mask.
    ``method``: constants.RANSAC or constants.LMEDS.
    ``max_iters``/``confidence``: OpenCV findHomography's adaptive-loop
    knobs (defaults 2000 / 0.995 — what the reference's call at
    src/lib.rs:267-276 uses implicitly).
    """
    m = src_pts.shape[0]
    count = jnp.sum(valid.astype(jnp.int32))
    countf = jnp.maximum(count.astype(jnp.float32), 1.0)

    src_n, t_src = _normalise_points(src_pts, valid)
    dst_n, t_dst = _normalise_points(dst_pts, valid)
    thresh_sq = jnp.float32(reproj_threshold) ** 2
    t_dst_inv = jnp.linalg.inv(t_dst)
    order = jnp.argsort(jnp.where(valid, 0, 1), stable=True)

    def gen_slab(k, n_hyp: int):
        """Sample n_hyp 4-point hypotheses -> (h_px [n,3,3], errs [n,M],
        ok [n])."""
        pos = jax.random.randint(k, (n_hyp, 4), 0, jnp.maximum(count, 1))
        samp = order[pos]
        ok_samp = _sample_ok(samp, src_pts, dst_pts, count)
        h_all = jax.vmap(lambda idx: _solve_h_4pt(src_n[idx], dst_n[idx]))(
            samp
        )
        finite = jnp.all(jnp.isfinite(h_all.reshape(n_hyp, -1)), axis=1)
        ok_samp = ok_samp & finite
        h_all = jnp.where(
            finite[:, None, None], h_all, jnp.eye(3, dtype=jnp.float32)
        )
        # errors in *unnormalised* pixel units: denormalise per hypothesis
        h_px = jnp.einsum(
            "ij,sjk,kl->sil", t_dst_inv, h_all, t_src, precision=_HIGHEST
        )
        errs = jax.vmap(lambda h: _sq_reproj_error(h, src_pts, dst_pts))(h_px)
        errs = jnp.where(valid[None, :], errs, _BIG)
        errs = jnp.where(jnp.isfinite(errs), errs, _BIG)
        return h_px, errs, ok_samp

    if method == 0:
        # OpenCV method=0: one least-squares DLT over ALL points (no
        # robust loop) + LM refinement.  Reachable API surface: the
        # reference's `method` field is a raw i32 handed straight to
        # findHomography (src/lib.rs:267-276).
        wts = valid.astype(jnp.float32)
        h_ls = _dlt_least_squares(src_n, dst_n, wts)
        h_px = _denormalise(t_dst_inv, h_ls, t_src)
        h_px = h_px / jnp.where(
            jnp.abs(h_px[2, 2]) < 1e-12, 1e-12, h_px[2, 2]
        )
        h_ref = _gauss_newton_refine(
            h_px, src_pts, dst_pts, wts, refine_iters
        )
        h_ref = h_ref / jnp.where(
            jnp.abs(h_ref[2, 2]) < 1e-12, 1e-12, h_ref[2, 2]
        )
        ok = (count >= 4) & jnp.all(jnp.isfinite(h_ref))
        return HomographyResult(
            h=h_ref, inliers=valid, num_inliers=count, ok=ok
        )

    if method == constants.LMEDS:
        # OpenCV's LMEDS registrator runs a fixed iteration budget; keep
        # the one-shot batched form (median scoring needs all errors).
        n_hyp = min(max_iters, 1024)
        h_px, errs, ok_samp = gen_slab(key, n_hyp)
        errs_sorted = jnp.sort(errs, axis=1)
        med_idx = jnp.maximum((count - 1) // 2, 0)
        scores = errs_sorted[:, med_idx]
        scores = jnp.where(ok_samp, scores, _BIG)
        best = jnp.argmin(scores)
        med = scores[best]
        sigma = 2.5 * 1.4826 * (
            1.0 + 5.0 / jnp.maximum(countf - 4.0, 1.0)
        ) * jnp.sqrt(med)
        inl_thresh = jnp.maximum(sigma * sigma, 1e-12)
        best_h = h_px[best]
    else:
        # Adaptive RANSAC: slabs of _SLAB hypotheses until OpenCV's
        # RANSACUpdateNumIters bound is met or max_iters is exhausted.
        log_conf = jnp.log(jnp.maximum(1.0 - jnp.float32(confidence), 1e-12))

        def needed_iters(best_ninl):
            w = best_ninl.astype(jnp.float32) / countf
            denom = jnp.log(jnp.maximum(1.0 - w**4, 1e-30))
            need = jnp.where(
                best_ninl >= 4, jnp.ceil(log_conf / denom), jnp.float32(max_iters)
            )
            return jnp.clip(need, 1.0, max_iters).astype(jnp.int32)

        def cond(c):
            k, best_h, best_ninl, done = c
            return done < jnp.minimum(needed_iters(best_ninl), max_iters)

        def body(c):
            k, best_h, best_ninl, done = c
            k, sub = jax.random.split(k)
            h_px, errs, ok_samp = gen_slab(sub, _SLAB)
            n_inl = jnp.sum(errs <= thresh_sq, axis=1)
            n_inl = jnp.where(ok_samp, n_inl, -1)
            sbest = jnp.argmax(n_inl)
            better = n_inl[sbest] > best_ninl
            best_h = jnp.where(better, h_px[sbest], best_h)
            best_ninl = jnp.maximum(best_ninl, n_inl[sbest])
            return (k, best_h, best_ninl, done + _SLAB)

        init = (
            key,
            jnp.eye(3, dtype=jnp.float32),
            jnp.int32(-1),
            jnp.int32(0),
        )
        _, best_h, best_ninl, _ = jax.lax.while_loop(cond, body, init)
        inl_thresh = thresh_sq

    best_err = _sq_reproj_error(best_h, src_pts, dst_pts)
    best_err = jnp.where(jnp.isfinite(best_err), best_err, _BIG)
    inliers = (best_err <= inl_thresh) & valid
    num_inl = jnp.sum(inliers.astype(jnp.int32))
    wts = inliers.astype(jnp.float32)

    # least-squares DLT on inliers (normalised coords), then GN polish
    h_ls = _dlt_least_squares(src_n, dst_n, wts)
    h_ls_px = _denormalise(t_dst_inv, h_ls, t_src)
    h_ls_px = h_ls_px / jnp.where(
        jnp.abs(h_ls_px[2, 2]) < 1e-12, 1e-12, h_ls_px[2, 2]
    )
    good_ls = jnp.all(jnp.isfinite(h_ls_px)) & (num_inl >= 4)
    h_ref = jnp.where(good_ls, h_ls_px, best_h)
    h_ref = _gauss_newton_refine(h_ref, src_pts, dst_pts, wts, refine_iters)
    h_ref = h_ref / jnp.where(jnp.abs(h_ref[2, 2]) < 1e-12, 1e-12, h_ref[2, 2])

    # recompute the inlier set under the refined H (like OpenCV's final mask)
    final_err = _sq_reproj_error(h_ref, src_pts, dst_pts)
    final_inl = (final_err <= inl_thresh) & valid
    ok = (
        (count >= 4)
        & jnp.all(jnp.isfinite(h_ref))
        & (num_inl >= 4)
    )
    return HomographyResult(
        h=h_ref,
        inliers=final_inl,
        num_inliers=jnp.sum(final_inl.astype(jnp.int32)),
        ok=ok,
    )

"""``keypoint_match`` pipeline — ORB/RANSAC-aligned burst stacking.

Counterpart of the reference's dispatcher and two pipelines
(``keypoint_match`` src/lib.rs:129-144, ``keypoint_match_no_scale``
src/lib.rs:146-353, ``keypoint_match_scale_down`` src/lib.rs:355-601),
redesigned for an accelerator: one batched device program runs ORB on every
frame, Hamming-matmul 2-NN matching against frame 0, ratio/sort/keep
filtering, vectorised RANSAC homography, full-res perspective warps and
a masked mean over the frame axis.

Per-frame drop semantics preserved (SURVEY.md §2c fault tolerance):
frames with < 5 surviving matches (src/lib.rs:240-242), failed or
non-3x3 homographies, or |det H| < 1e-6 (src/lib.rs:279-287) are
dropped and counted.  Deviation (documented, SURVEY.md §3.1 quirk): the
reference's Rayon fold can nondeterministically seed a dropped-frame
accumulator with an extra copy of frame 0; we use the deterministic
semantics — dropped frames contribute nothing, the divisor is the
number of kept frames.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..errors import InvalidParamsError, NotEnoughFilesError
from ..params import KeyPointMatchParameters
from ..ops import color, matcher, orb, ransac, resize, warp
from ..ops.warp_batch import warp_accumulate_rgb, warp_frames_batch
from ..utils import io


def _adjust_h_for_scale(h: jnp.ndarray, small_hw, full_hw) -> jnp.ndarray:
    """Rescale a homography estimated on scaled frames to full resolution
    (ref src/utils.rs:218-248: h[0,2]*=sx, h[1,2]*=sy, h[2,0]/=sx,
    h[2,1]/=sy)."""
    sx = full_hw[1] / small_hw[1]
    sy = full_hw[0] / small_hw[0]
    h = h.at[..., 0, 2].mul(sx)
    h = h.at[..., 1, 2].mul(sy)
    h = h.at[..., 2, 0].divide(sx)
    h = h.at[..., 2, 1].divide(sy)
    return h


@functools.partial(jax.jit, static_argnames=("scale_hw",))
def _grey_and_detect(
    frames_u8: jnp.ndarray,
    scale_hw: Optional[tuple] = None,
    det_mask: Optional[jnp.ndarray] = None,
):
    """Stage 1: grayscale (+ optional INTER_AREA scale-down) and batched
    ORB detection/description over all frames.  ``det_mask`` is a
    prepared binary [h,w] mask at the detection grid, shared by every
    frame (cv2 detectAndCompute's mask; see ops/orb.py).  uint16
    bursts detect on their high-byte reduction (FAST thresholds are
    8-bit-domain); stacking keeps the full depth."""
    grey = color.rgb_to_gray_u8(color.depth_reduce_u8(frames_u8))
    if scale_hw is not None:
        grey = resize.resize(grey, scale_hw, constants.INTER_AREA)
    return jax.vmap(
        lambda g: orb.orb_detect_and_compute(g, mask=det_mask)
    )(grey)


def detect_chunk_budget(n: int, h: int, w: int) -> int:
    """Frames per detection dispatch at grid (h, w).

    The fused FAST formulation (ops/fast.py) keeps ~8 image-sized live
    f32 buffers per frame after XLA fusion.  The fixed 5.4 GB budget of
    transient detection state gives 20-frame chunks at 4K; it has not
    been measured against the H100's memory or speed
    (tests/test_pipeline_keypoint.py::test_detect_chunk_budget_fence).
    """
    budget = int(5.4e9)  # bytes of transient detection state
    per_frame = 8 * h * w * 4
    return max(1, min(n, budget // max(per_frame, 1)))


@functools.partial(jax.jit, static_argnames=("chunk", "scale_hw"))
def _grey_and_detect_scan(
    frames_u8: jnp.ndarray,  # [n, H, W, 3], n a multiple of chunk
    chunk: int,
    scale_hw: Optional[tuple] = None,
    det_mask: Optional[jnp.ndarray] = None,
):
    """Stage 1 as ONE device program: ``lax.scan`` over chunk-sized
    slices of the burst.  Per-step transients stay at the chunk budget
    (each scan step is the same graph the per-chunk dispatch ran), but
    the host dispatches once."""
    n = frames_u8.shape[0]
    stacked = frames_u8.reshape((n // chunk, chunk) + frames_u8.shape[1:])

    def body(carry, chunk_frames):
        grey = color.rgb_to_gray_u8(color.depth_reduce_u8(chunk_frames))
        if scale_hw is not None:
            grey = resize.resize(grey, scale_hw, constants.INTER_AREA)
        feats = jax.vmap(
            lambda g: orb.orb_detect_and_compute(g, mask=det_mask)
        )(grey)
        return carry, feats

    _, feats = jax.lax.scan(body, 0, stacked)
    return jax.tree.map(
        lambda x: x.reshape((n,) + x.shape[2:]), feats
    )


def detect_features_chunked(
    frames_u8, scale_hw: Optional[tuple] = None, chunk: Optional[int] = None,
    det_mask: Optional[jnp.ndarray] = None,
):
    """Host-chunked stage 1: the dense FAST/ORB programs keep ~8 HW-sized
    f32 intermediates per frame, so a whole 4K burst is not vmapped at
    once (see :func:`detect_chunk_budget`).  Multi-chunk bursts run as
    ONE scan-over-chunks program (:func:`_grey_and_detect_scan`;
    LIBSTACKER_DETECT_SCAN=0 restores the per-chunk dispatch loop)."""
    n = frames_u8.shape[0]
    if scale_hw is not None:
        h, w = scale_hw
    else:
        h, w = frames_u8.shape[1], frames_u8.shape[2]
    if chunk is None:
        env = os.environ.get("LIBSTACKER_DETECT_CHUNK")
        if env:
            chunk = max(1, min(n, int(env)))
    if chunk is None:
        chunk = detect_chunk_budget(n, h, w)
    if chunk >= n:
        return _grey_and_detect(frames_u8, scale_hw=scale_hw,
                                det_mask=det_mask)
    # balance chunk sizes (ceil(n / nchunks)) so tail padding wastes at
    # most nchunks-1 frames of detection across the whole burst
    chunk = -(-n // (-(-n // chunk)))
    if os.environ.get("LIBSTACKER_DETECT_SCAN", "1") != "0":
        pad = (-n) % chunk
        sub = frames_u8
        if pad:
            reps = jnp.repeat(frames_u8[-1:], pad, axis=0)
            sub = jnp.concatenate([frames_u8, reps], axis=0)
        feats = _grey_and_detect_scan(
            sub, chunk, scale_hw=scale_hw, det_mask=det_mask
        )
        if pad:
            feats = jax.tree.map(lambda x: x[:n], feats)
        return feats
    parts = []
    for s0 in range(0, n, chunk):
        e = min(s0 + chunk, n)
        sub = frames_u8[s0:e]
        if e - s0 < chunk:
            # pad the tail chunk to the full chunk shape (repeat the
            # last frame) so every chunk hits ONE compiled program; the
            # padded frames' features are sliced off below
            reps = jnp.repeat(sub[-1:], chunk - (e - s0), axis=0)
            sub = jnp.concatenate([sub, reps], axis=0)
        feats = _grey_and_detect(sub, scale_hw=scale_hw, det_mask=det_mask)
        if e - s0 < chunk:
            feats = jax.tree.map(lambda x: x[: e - s0], feats)
        parts.append(feats)
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)


@functools.partial(
    jax.jit, static_argnames=("method", "max_iters")
)
def _match_and_estimate(
    feats,
    key: jax.Array,
    method: int,
    ransac_reproj_threshold: float,
    match_keep_ratio: float,
    match_ratio: float,
    max_iters: int = 2000,
    confidence: float = 0.995,
):
    """Stage 2: Hamming 2-NN matching against frame 0 + ratio/sort/keep
    filtering + vectorised RANSAC homography, vmapped over frames 1..N-1.

    Returns (hs [N-1,3,3], oks [N-1], match_counts, inlier_counts)."""
    q_desc = feats.descriptors[0]
    q_valid = feats.valid[0]
    q_xy = feats.xy[0]
    n = feats.descriptors.shape[0]

    def match_one(i_desc, i_valid, i_xy, subkey):
        knn = matcher.knn_match2(q_desc, i_desc, q_valid, i_valid)
        filt = matcher.ratio_filter_sort_keep(knn, match_ratio, match_keep_ratio)
        src = q_xy[filt.query_idx]  # frame-0 points (match.query)
        dst = i_xy[filt.train_idx]  # frame-i points (match.train)
        enough = filt.count >= 5  # ref src/lib.rs:240-242
        # find_homography(dst_pts, src_pts): H maps frame-i -> frame-0
        res = ransac.find_homography(
            dst,
            src,
            filt.keep,
            subkey,
            method=method,
            reproj_threshold=ransac_reproj_threshold,
            max_iters=max_iters,
            confidence=confidence,
        )
        det = jnp.linalg.det(res.h)
        ok = enough & res.ok & (jnp.abs(det) >= 1e-6)  # ref src/lib.rs:279-287
        return res.h, ok, filt.count, res.num_inliers

    subkeys = jax.random.split(key, n - 1)
    return jax.vmap(match_one)(
        feats.descriptors[1:], feats.valid[1:], feats.xy[1:], subkeys
    )


@functools.partial(
    jax.jit, static_argnames=("border_mode", "scale_hw")
)
def _warp_and_accumulate_chunk(
    frames_u8: jnp.ndarray,  # [C,H,W,3] — current frames only, no frame 0
    hs: jnp.ndarray,  # [C,3,3]
    oks: jnp.ndarray,  # [C] bool
    border_mode: int,
    border_value,
    scale_hw: Optional[tuple] = None,
):
    """Rescale the homographies if estimated on scaled frames,
    perspective-warp every frame to the reference grid, masked sum
    over the chunk."""
    h, w = frames_u8.shape[1], frames_u8.shape[2]
    if scale_hw is not None:
        hs = _adjust_h_for_scale(hs, scale_hw, (h, w))
    # dropped frames contribute nothing, but their (possibly wild or
    # non-finite) matrices must not reach the warp: NaN * 0 == NaN
    hs = jnp.where(oks[:, None, None], hs, jnp.eye(3, dtype=hs.dtype))

    bv = jnp.asarray(border_value[:3], jnp.float32)
    border, _ = warp._resolve_border(border_mode, 0.0)
    if border in ("constant", "transparent"):
        # frame-by-frame warp+accumulate of the RAW integer burst;
        # TRANSPARENT over a zero dst base is tap-wise CONSTANT 0 (see
        # ops.warp._sample_bilinear)
        return warp_accumulate_rgb(
            frames_u8, hs, oks, perspective=True,
            border_value=jnp.zeros(3) if border == "transparent" else bv,
        )
    warped = warp_frames_batch(
        color.to_unit_f32(frames_u8), hs, perspective=True,
        border_value=bv, border_mode=border_mode,
    )
    valid = oks.astype(jnp.float32)[:, None, None, None]
    return jnp.sum(warped * valid, axis=0)


@functools.partial(
    jax.jit, static_argnames=("border_mode", "scale_hw")
)
def _warp_and_accumulate(
    frames_u8: jnp.ndarray,
    hs: jnp.ndarray,
    oks: jnp.ndarray,
    border_mode: int,
    border_value,
    scale_hw: Optional[tuple] = None,
):
    """Stage 3 for the whole-burst path: frame 0 plus the masked sum of
    the aligned frames 1..N-1."""
    return color.to_unit_f32(frames_u8[0]) + _warp_and_accumulate_chunk(
        frames_u8[1:], hs, oks, border_mode, border_value,
        scale_hw=scale_hw,
    )


def _prepare_det_mask(mask, full_hw, scale_hw):
    """Validate + binarise the user's detection mask and, on the scaled
    path, shrink it conservatively to the detection grid (same contract
    as models/ecc's mask helper)."""
    if mask is None:
        return None
    mask = np.asarray(mask)
    if mask.ndim == 3 and mask.shape[-1] == 1:
        mask = mask[..., 0]
    if mask.shape != tuple(full_hw):
        raise InvalidParamsError(
            f"mask must be [H,W] matching the frames, got {mask.shape}"
            f" for frames {tuple(full_hw)}"
        )
    from .ecc import _ecc_mask_jit

    return _ecc_mask_jit(jnp.asarray(mask), scale_hw=scale_hw)


def _single_frame_out(frame_u8: np.ndarray, params) -> np.ndarray:
    """n==1 stack: frame 0 itself — bilinearly upsampled when a
    super-resolution output grid was requested (there are no other
    frames to recover detail from)."""
    frame_u8 = np.asarray(frame_u8)  # one frame; device inputs download
    scale = 65535.0 if frame_u8.dtype == np.uint16 else 255.0
    out = frame_u8.astype(np.float32) / scale
    f = getattr(params, "output_scale", 1)
    if f > 1:
        h, w = out.shape[:2]
        out = np.asarray(
            resize.resize(
                jnp.asarray(out), (h * f, w * f), constants.INTER_LINEAR
            )
        )
    return out


def _keypoint_match_arrays_sharded(
    frames: np.ndarray,
    params: KeyPointMatchParameters,
    scale_hw,
    seed: int,
    return_stats: bool,
    mask,
    mesh,
    device_output: bool = False,
):
    """Multi-chip ``keypoint_match_arrays``: batched ORB + matching +
    RANSAC + warp run as ONE shard_map program over the mesh's 'data'
    axis (parallel.keypoint_stack_step) with feature parity —
    scale-down, detection masks, uint16, all border modes, sigma-clip.
    Return semantics identical to the single-device path
    ((dropped, stacked[, stats]))."""
    from ..parallel import mesh as pmesh
    from .ecc import _pad_burst

    n, h, w = frames.shape[:3]
    sr_factor = getattr(params, "output_scale", 1)
    border = constants.border_mode_name(params.border_mode)
    if sr_factor > 1 and border not in ("constant", "transparent"):
        raise InvalidParamsError(
            "output_scale > 1 requires BORDER_CONSTANT or "
            f"BORDER_TRANSPARENT, got border mode {border!r}"
        )
    if (getattr(params, "stacking", "mean") == "sigma_clip"
            and border not in ("constant", "transparent")):
        raise InvalidParamsError(
            "stacking='sigma_clip' requires BORDER_CONSTANT or "
            "BORDER_TRANSPARENT (sample inclusion is defined by warp "
            f"coverage), got border mode {border!r}"
        )
    det_mask = _prepare_det_mask(mask, (h, w), scale_hw)
    # frame 0's features, detected once and replicated (the sharded
    # step matches every lane — frame 0 included, at identity —
    # against them)
    feats0 = detect_features_chunked(
        jnp.asarray(frames[:1]), scale_hw=scale_hw, det_mask=det_mask
    )
    ref_feats = jax.tree.map(lambda x: x[0], feats0)
    ndata = mesh.shape["data"]
    frames_p, lane_valid = _pad_burst(frames, ndata)
    frames_j = pmesh.shard_frames(jnp.asarray(frames_p), mesh)
    sigma = getattr(params, "stacking", "mean") == "sigma_clip"
    total, ok_j, mc_j, ic_j = pmesh.keypoint_stack_step(
        frames_j,
        ref_feats,
        mesh,
        method=params.method,
        ransac_reproj_threshold=params.ransac_reproj_threshold,
        match_ratio=params.match_ratio,
        match_keep_ratio=params.match_keep_ratio,
        max_iters=params.max_iters,
        confidence=params.confidence,
        seed=seed,
        stacking=getattr(params, "stacking", "mean"),
        sigma_kappa=params.sigma_kappa,
        sigma_iters=params.sigma_iters,
        scale_hw=scale_hw,
        det_mask=det_mask,
        border_mode=params.border_mode,
        border_value=tuple(params.border_value),
        lane_valid=jnp.asarray(lane_valid),
        return_extras=True,
        output_scale=sr_factor,
    )
    ok = np.asarray(ok_j)[:n]
    kept = int(ok.sum())
    dropped = n - kept
    fetch = (lambda x: x) if device_output else np.asarray
    final = sigma or sr_factor > 1  # already a finalised image
    out = fetch(total) if final else fetch(total) / max(kept, 1)
    if return_stats:
        from ..utils.tracing import PipelineStats

        stats = PipelineStats(
            frames_total=n,
            frames_kept=kept,
            frames_dropped=dropped,
            match_counts=np.asarray(mc_j)[1:n].tolist(),
            inlier_counts=np.asarray(ic_j)[1:n].tolist(),
        )
        return dropped, out, stats
    return dropped, out


def keypoint_match_arrays(
    frames: np.ndarray,
    params: KeyPointMatchParameters = KeyPointMatchParameters(),
    scale_down_width: Optional[float] = None,
    seed: int = 0,
    return_stats: bool = False,
    mask: Optional[np.ndarray] = None,
    mesh=None,
    device_output: bool = False,
):
    """Array-based ``keypoint_match``: ``frames`` is ``[N,H,W,3] uint8``
    RGB.  Returns ``(dropped_count, stacked [H,W,3] float32 RGB in
    [0,1])`` like the reference returns ``(i32, Mat)``
    (src/lib.rs:129-144).  With ``params.output_scale = f > 1`` the
    stacked image is ``[f*H, f*W, 3]`` (super-resolution stack).

    ``mask`` ([H,W], nonzero = valid) is cv2 ``detectAndCompute``'s
    detection mask, applied to EVERY frame (sensor-fixed artifacts:
    lens dirt, watermarks, dead regions): no keypoints are detected in
    the masked region, so static overlay content cannot vote for an
    identity homography.  Stacking is unaffected.  ``frames`` may be a
    device-resident ``jax.Array`` (no re-upload; numpy bursts are
    staged once).

    ``mesh``: ``None`` (single device), ``"auto"`` (shard the frame
    axis over every visible device when there is more than one), or a
    ``jax.sharding.Mesh`` with a 'data' axis — the reference's
    invisible-in-API parallelism (src/lib.rs:188).  Feature parity is
    kept except super-resolution (``output_scale > 1``), which
    raises.  RANSAC draws per-frame keys from the same seed but a
    different stream than the single-device path, so warp estimates
    agree statistically, not bitwise."""
    params.validate()
    if not isinstance(frames, jax.Array):
        # device-resident bursts pass through untouched (np.asarray on
        # a jax.Array is a full D2H download)
        frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise InvalidParamsError(
            f"frames must be [N,H,W,3] uint8/uint16, got {frames.shape}"
        )
    if frames.dtype not in (np.uint8, np.uint16):
        raise InvalidParamsError(
            f"frames must be uint8 or uint16, got {frames.dtype}"
        )
    n, h, w = frames.shape[:3]
    if n == 0:
        raise NotEnoughFilesError()

    scale_hw = None
    if scale_down_width is not None:
        if scale_down_width >= w:
            raise InvalidParamsError(
                "scale_down_to was larger (or equal) to the full image "
                f"width: full_size:{w}, scale_down_to:{scale_down_width}"
            )
        scale_hw = resize.scale_image_size(h, w, scale_down_width)

    if n == 1:
        # reference: single-frame stack is frame 0 itself; keep the
        # return arity consistent with the n>1 path (mirrors
        # models/ecc.py's n==1 guard)
        out = _single_frame_out(frames[0], params)
        if return_stats:
            from ..utils.tracing import PipelineStats

            return 0, out, PipelineStats(
                frames_total=1, frames_kept=1, frames_dropped=0
            )
        return 0, out

    from .ecc import _resolve_mesh

    mesh = _resolve_mesh(mesh)
    if mesh is not None:
        return _keypoint_match_arrays_sharded(
            frames, params, scale_hw, seed, return_stats, mask, mesh,
            device_output,
        )

    frames_j = jnp.asarray(frames)
    det_mask = _prepare_det_mask(mask, (h, w), scale_hw)
    feats = detect_features_chunked(
        frames_j, scale_hw=scale_hw, det_mask=det_mask
    )
    hs, oks, mcounts, icounts = _match_and_estimate(
        feats,
        jax.random.PRNGKey(seed),
        method=params.method,
        ransac_reproj_threshold=params.ransac_reproj_threshold,
        match_keep_ratio=params.match_keep_ratio,
        match_ratio=params.match_ratio,
        max_iters=params.max_iters,
        confidence=params.confidence,
    )
    border = constants.border_mode_name(params.border_mode)
    sigma = getattr(params, "stacking", "mean") == "sigma_clip"
    sr_factor = getattr(params, "output_scale", 1)
    if (sigma or sr_factor > 1) and border not in (
        "constant", "transparent"
    ):
        raise InvalidParamsError(
            "stacking='sigma_clip' / output_scale>1 require "
            "BORDER_CONSTANT or BORDER_TRANSPARENT (sample inclusion is "
            f"defined by warp coverage), got border mode {border!r}"
        )
    if sr_factor > 1:
        # beyond-reference super-resolution stack (ops/stack.py)
        from ..ops import stack as stack_ops

        hs_full = jnp.asarray(hs)
        if scale_hw is not None:
            hs_full = _adjust_h_for_scale(hs_full, scale_hw, (h, w))
        stacked_img = stack_ops.super_res_stack(
            frames_j, hs_full, oks, factor=sr_factor, perspective=True,
        )
    elif sigma:
        # beyond-reference robust stack (ops/stack.py): per-pixel
        # kappa-sigma outlier rejection over the re-warped burst
        from ..ops import stack as stack_ops

        hs_full = jnp.asarray(hs)
        if scale_hw is not None:
            hs_full = _adjust_h_for_scale(hs_full, scale_hw, (h, w))
        stacked_img, clip_frac = stack_ops.kappa_sigma_stack(
            frames_j, hs_full, oks, perspective=True,
            kappa=params.sigma_kappa, iters=params.sigma_iters,
        )
    else:
        stacked_sum = _warp_and_accumulate(
            frames_j,
            hs,
            oks,
            border_mode=params.border_mode,
            border_value=tuple(params.border_value),
            scale_hw=scale_hw,
        )
    oks = np.asarray(oks)
    kept = 1 + int(oks.sum())
    dropped = int((~oks).sum())
    fetch = (lambda x: x) if device_output else np.asarray
    out = (
        fetch(stacked_img)
        if (sigma or sr_factor > 1)
        else fetch(stacked_sum) / kept
    )
    if return_stats:
        from ..utils.tracing import PipelineStats

        stats = PipelineStats(
            frames_total=n,
            frames_kept=kept,
            frames_dropped=dropped,
            match_counts=np.asarray(mcounts).tolist(),
            inlier_counts=np.asarray(icounts).tolist(),
            clipped_sample_frac=clip_frac if sigma else None,
        )
        return dropped, out, stats
    return dropped, out


def keypoint_match(
    files: Sequence,
    params: KeyPointMatchParameters = KeyPointMatchParameters(),
    scale_down_width: Optional[float] = None,
    seed: int = 0,
    return_stats: bool = False,
    mask: Optional[np.ndarray] = None,
    preserve_depth: bool = False,
    mesh=None,
):
    """Align and stack image files by ORB keypoint matching
    (ref src/lib.rs:129-144).  ``mask`` excludes regions from keypoint
    detection in every frame (see :func:`keypoint_match_arrays`).
    ``preserve_depth`` decodes 16-bit files to uint16 and stacks at
    full depth (detection is unchanged).  ``mesh`` shards the burst
    over multiple chips (see :func:`keypoint_match_arrays`)."""
    frames = io.load_frames(files, preserve_depth=preserve_depth)
    return keypoint_match_arrays(
        frames, params, scale_down_width, seed, return_stats, mask=mask,
        mesh=mesh,
    )


def keypoint_match_stream(
    files: Sequence,
    params: KeyPointMatchParameters = KeyPointMatchParameters(),
    scale_down_width: Optional[float] = None,
    seed: int = 0,
    chunk_size: int = 16,
    mask: Optional[np.ndarray] = None,
    preserve_depth: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 4,
    return_stats: bool = False,
    mesh=None,
):
    """Streaming ``keypoint_match`` for bursts larger than HBM: frames
    are decoded (one chunk ahead on a background thread), ORB-matched
    against frame 0 and accumulated in chunks of ``chunk_size``; only
    frame 0's features and the running sum stay resident.  The final
    partial chunk is padded so no per-burst-length recompile happens.
    Returns ``(dropped_count, stacked [H,W,3] float32 RGB)`` like
    :func:`keypoint_match`.

    ``checkpoint_path`` makes the run RESUMABLE (see
    :func:`libstacker_tpu.models.ecc.ecc_match_stream`); the RANSAC
    RNG stream is replayed to the resume point, so a resumed run is
    bit-identical to an uninterrupted one.

    ``params.stacking = "sigma_clip"`` streams too: the align pass
    stores the (tiny) homographies, then the moment accumulators of
    ops/stack.py stream over ``1 + sigma_iters`` extra decode passes
    (see models.ecc._stream_sigma_stack).

    ``mesh`` (r4 VERDICT item 3): streaming composes with multi-chip —
    each chunk is sharded over the mesh's 'data' axis
    (``parallel.keypoint_stack_step`` per chunk; the sigma-clip sweeps
    psum their moments).  ``chunk_size`` is rounded up to a multiple of
    the data-axis size.  The sharded RANSAC draws per-lane keys from
    ``seed`` (not the single-device per-chunk key stream), so warp
    estimates agree statistically with the unsharded stream, not
    bitwise."""
    params.validate()
    from .ecc import _resolve_mesh

    mesh = _resolve_mesh(mesh)
    if mesh is not None:
        ndata = mesh.shape["data"]
        chunk_size = -(-chunk_size // ndata) * ndata
    sigma = getattr(params, "stacking", "mean") == "sigma_clip"
    if getattr(params, "output_scale", 1) != 1:
        raise InvalidParamsError(
            "output_scale stacking is not available in the"
            " streaming pipelines; use the whole-burst entry points"
        )
    if sigma:
        border = constants.border_mode_name(params.border_mode)
        if border not in ("constant", "transparent"):
            raise InvalidParamsError(
                "stacking='sigma_clip' requires BORDER_CONSTANT or "
                "BORDER_TRANSPARENT (sample inclusion is defined by "
                f"warp coverage), got border mode {border!r}"
            )
    files = io.normalize_files(files)
    if not files:
        raise NotEnoughFilesError()

    ref = io.load_frames(files[:1], preserve_depth=preserve_depth)
    h, w = ref.shape[1:3]
    scale_hw = None
    if scale_down_width is not None:
        if scale_down_width >= w:
            raise InvalidParamsError(
                "scale_down_to was larger (or equal) to the full image "
                f"width: full_size:{w}, scale_down_to:{scale_down_width}"
            )
        scale_hw = resize.scale_image_size(h, w, scale_down_width)
    if len(files) == 1:
        scale = 65535.0 if ref.dtype == np.uint16 else 255.0
        out = ref[0].astype(np.float32) / scale
        if return_stats:
            from ..utils.tracing import PipelineStats

            return 0, out, PipelineStats(
                frames_total=1, frames_kept=1, frames_dropped=0
            )
        return 0, out

    ref_j = jnp.asarray(ref)
    det_mask = _prepare_det_mask(mask, (h, w), scale_hw)
    feats0 = detect_features_chunked(
        ref_j, scale_hw=scale_hw, det_mask=det_mask
    )
    acc = color.to_unit_f32(ref_j[0])
    key = jax.random.PRNGKey(seed)
    all_ok = []
    all_mc = []
    all_ic = []
    all_hs = []
    ckpt = None
    chunks_done = 0
    sigma_resume = None
    align_done = False
    if checkpoint_path is not None:
        from ..utils import checkpoint as ckpt_mod

        ckpt = ckpt_mod.StreamCheckpoint(
            checkpoint_path,
            ckpt_mod.burst_key(files, params, scale_down_width,
                               chunk_size, extra=f"kp|{seed}", mask=mask),
        )
        chunks_done, state = ckpt.load()
        if state is not None and int(state.get("phase", 0)) == 1:
            # sigma-clip sweep phase (r4 VERDICT item 9): align done —
            # restore its products and resume inside the moment sweeps
            sigma_resume = dict(
                pass_idx=int(state["pass_idx"]),
                cursor=int(chunks_done),
                part=(state["part0"], state["part1"], state["part2"]),
                base=(
                    (state["base0"], state["base1"], state["base2"])
                    if int(state["has_base"]) else None
                ),
                total_s0=float(state["total_s0"]),
            )
            all_hs.append(state["al_warps"].astype(np.float32))
            all_ok.append(state["al_ok"].astype(bool))
            all_mc.append(state["al_mc"])
            all_ic.append(state["al_ic"])
            align_done = True
            chunks_done = 0
        elif state is not None and chunks_done > 0:
            if "acc" in state:
                acc = jnp.asarray(state["acc"])
            if state["ok"].size:
                all_ok.append(state["ok"].astype(bool))
            if state.get("mc") is not None and state["mc"].size:
                all_mc.append(state["mc"])
                all_ic.append(state["ic"])
            if sigma and state.get("hs") is not None and state["hs"].size:
                all_hs.append(state["hs"].astype(np.float32))
            # replay the per-chunk RNG stream to the resume point so
            # the remaining chunks draw the same RANSAC hypotheses an
            # uninterrupted run would
            for _ in range(chunks_done):
                key, _ = jax.random.split(key)

    def save_align():
        st = dict(
            ok=np.concatenate(all_ok),
            mc=np.concatenate(all_mc),
            ic=np.concatenate(all_ic),
        )
        if sigma:
            st["hs"] = (
                np.concatenate(all_hs) if all_hs
                else np.zeros((0, 3, 3), np.float32)
            )
        else:
            st["acc"] = np.asarray(acc)
        ckpt.save(chunks_done, **st)
    # async H2D double-buffering: upload chunk i+1 while chunk i's
    # detection/matching runs (decode-ahead already overlaps on a host
    # thread in io.prefetched_chunks)
    gen = iter(()) if align_done else io.prefetched_chunks(
        files, chunk_size, h, w, start=1 + chunks_done * chunk_size,
        preserve_depth=preserve_depth,
    )

    def put_next():
        frames = next(gen, None)
        if frames is None:
            return None
        padded = io.pad_chunk(frames, chunk_size)
        if mesh is not None:
            from ..parallel import mesh as pmesh

            return pmesh.shard_frames(jnp.asarray(padded), mesh), \
                frames.shape[0]
        return jax.device_put(padded), frames.shape[0]

    ref_feats = (
        jax.tree.map(lambda x: x[0], feats0) if mesh is not None else None
    )
    cur = put_next()
    while cur is not None:
        frames_j, n_real = cur
        cur = put_next()
        if mesh is not None:
            from ..parallel import mesh as pmesh

            real_np = np.arange(chunk_size) < n_real
            kw = dict(
                method=params.method,
                ransac_reproj_threshold=params.ransac_reproj_threshold,
                match_ratio=params.match_ratio,
                match_keep_ratio=params.match_keep_ratio,
                max_iters=params.max_iters,
                confidence=params.confidence,
                seed=seed,
                scale_hw=scale_hw,
                det_mask=det_mask,
                lane_valid=jnp.asarray(real_np),
            )
            if sigma:
                hs_rep, ok_np, mc_np, ic_np = pmesh.keypoint_solve_step(
                    frames_j, ref_feats, mesh, **kw
                )
                all_hs.append(hs_rep[:n_real].astype(np.float32))
            else:
                total, ok_np, mc_np, ic_np = pmesh.keypoint_stack_step(
                    frames_j, ref_feats, mesh,
                    border_mode=params.border_mode,
                    border_value=tuple(params.border_value),
                    return_extras=True, **kw,
                )
                acc = acc + total
            all_ok.append(np.asarray(ok_np, bool)[:n_real])
            all_mc.append(np.asarray(mc_np)[:n_real])
            all_ic.append(np.asarray(ic_np)[:n_real])
            chunks_done += 1
            if ckpt is not None and (
                chunks_done % max(checkpoint_every, 1) == 0 or cur is None
            ):
                save_align()
            continue
        feats = detect_features_chunked(
            frames_j, scale_hw=scale_hw, det_mask=det_mask
        )
        feats_all = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b], axis=0), feats0, feats
        )
        key, sub = jax.random.split(key)
        hs, oks, mcounts, icounts = _match_and_estimate(
            feats_all,
            sub,
            method=params.method,
            ransac_reproj_threshold=params.ransac_reproj_threshold,
            match_keep_ratio=params.match_keep_ratio,
            match_ratio=params.match_ratio,
            max_iters=params.max_iters,
            confidence=params.confidence,
        )
        oks = oks & (jnp.arange(chunk_size) < n_real)
        oks_np = np.asarray(oks)
        if sigma:
            # sigma-clip streams its moment passes AFTER the align
            # pass: store this chunk's (scale-adjusted) homographies
            hs_np = np.asarray(jax.device_get(hs), np.float64)
            if scale_hw is not None:
                sx, sy = w / scale_hw[1], h / scale_hw[0]
                hs_np[:, 0, 2] *= sx
                hs_np[:, 1, 2] *= sy
                hs_np[:, 2, 0] /= sx
                hs_np[:, 2, 1] /= sy
            all_hs.append(hs_np[:n_real].astype(np.float32))
        else:
            acc = acc + _warp_and_accumulate_chunk(
                frames_j,
                hs,
                oks,
                border_mode=params.border_mode,
                border_value=tuple(params.border_value),
                scale_hw=scale_hw,
            )
        all_ok.append(oks_np[:n_real])
        all_mc.append(np.asarray(mcounts)[:n_real])
        all_ic.append(np.asarray(icounts)[:n_real])
        chunks_done += 1
        if ckpt is not None and (
            chunks_done % max(checkpoint_every, 1) == 0 or cur is None
        ):
            save_align()

    ok = np.concatenate(all_ok) if all_ok else np.zeros(0, bool)
    if ckpt is not None and not sigma:
        ckpt.remove()  # completed — the checkpoint has served its job
    kept = 1 + int(ok.sum())
    dropped = int((~ok).sum())
    clip_frac = None
    if sigma:
        from .ecc import _stream_sigma_stack

        mats_np = (
            np.concatenate(all_hs) if all_hs
            else np.zeros((0, 3, 3), np.float32)
        )
        out, clip_frac = _stream_sigma_stack(
            files, mats_np, ok, perspective=True,
            kappa=params.sigma_kappa, iters=params.sigma_iters,
            chunk_size=chunk_size, hw=(h, w),
            preserve_depth=preserve_depth, mesh=mesh,
            ckpt=ckpt, checkpoint_every=checkpoint_every,
            align_save=(
                dict(
                    warps=mats_np, ok=ok,
                    mc=(np.concatenate(all_mc) if all_mc
                        else np.zeros(0, np.int32)),
                    ic=(np.concatenate(all_ic) if all_ic
                        else np.zeros(0, np.int32)),
                )
                if ckpt is not None else None
            ),
            resume=sigma_resume,
        )
        if ckpt is not None:
            ckpt.remove()
    else:
        out = np.asarray(acc) / kept
    if return_stats:
        from ..utils.tracing import PipelineStats

        stats = PipelineStats(
            frames_total=len(files),
            frames_kept=kept,
            frames_dropped=dropped,
            match_counts=np.concatenate(all_mc).tolist()
            if all_mc else [],
            inlier_counts=np.concatenate(all_ic).tolist()
            if all_ic else [],
            clipped_sample_frac=clip_frac,
        )
        return dropped, out, stats
    return dropped, out

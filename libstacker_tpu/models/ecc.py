"""``ecc_match`` pipeline — ECC-aligned burst stacking.

Counterpart of the reference's ``ecc_match`` dispatcher and its two
pipelines (``src/lib.rs:702-717``, ``ecc_match_no_scaling``
src/lib.rs:719-847, ``ecc_match_scaling_down`` src/lib.rs:849-1028),
redesigned for an accelerator:

- frames are decoded on host into one ``[N,H,W,3] uint8`` tensor and
  shipped to device memory once;
- grayscale conversion, optional INTER_AREA scale-down, batched ECC
  solve, full-res warp and stack accumulation all run as jitted device
  programs over the whole burst (the Rayon fold/reduce at
  src/lib.rs:746-833 becomes a masked mean over the frame axis);
- the per-frame ECC convention is preserved exactly: template = current
  frame's grey, input = frame 0's grey (src/lib.rs:769-777), then the
  resulting warp is applied *forward* (non-inverse) to the current
  frame (src/lib.rs:780-803) with BORDER_CONSTANT 0;
- normalisation divides by the total frame count (src/lib.rs:837), and
  any per-frame ECC failure raises ProcessingError like the reference's
  ``?`` abort — or drops the frame when ``on_failure="drop"`` (flagged
  deviation, SURVEY.md §5).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import InvalidParamsError, NotEnoughFilesError, ProcessingError
from ..params import EccMatchParameters, MotionType
from ..ops import color, ecc as ecc_ops, resize, warp
from ..ops.warp_batch import warp_accumulate_rgb
from ..utils import io


def _solver_mode(params) -> Optional[str]:
    """EccMatchParameters.solver -> find_transform_ecc_batched's
    ``mode``.  The dataclass default 'forward' maps to None so the
    LIBSTACKER_ECC_MODE env override can flip the formulation without
    touching params; an explicit solver='lazy' always wins."""
    s = getattr(params, "solver", "forward")
    return s if s != "forward" else None


def _adjust_warp_for_scale(
    warps: jnp.ndarray,
    motion_type: MotionType,
    small_hw,
    full_hw,
) -> jnp.ndarray:
    """Upscale warp matrices estimated on scaled-down frames.

    Non-homography: scale the translation column by full/small ratios
    (ref src/lib.rs:941-951).  Homography: the f32 variant of
    ``adjust_homography_for_scale`` (ref src/lib.rs:952-958,
    src/utils.rs:218-248)."""
    sx = full_hw[1] / small_hw[1]
    sy = full_hw[0] / small_hw[0]
    if motion_type != MotionType.Homography:
        return warps.at[..., 0, 2].mul(sx).at[..., 1, 2].mul(sy)
    w = warps
    w = w.at[..., 0, 2].mul(sx)
    w = w.at[..., 1, 2].mul(sy)
    w = w.at[..., 2, 0].divide(sx)
    w = w.at[..., 2, 1].divide(sy)
    return w


@functools.partial(jax.jit, static_argnames=("scale_hw",))
def _ecc_grey_jit(frames_u8: jnp.ndarray, scale_hw: Optional[tuple] = None):
    """Stage 1: grayscale (raw 0..255 f32) + optional INTER_AREA
    scale-down of the whole burst.

    The resize runs on the uint8 grey and is rounded back to uint8
    BEFORE the float cast, matching the reference's scale_image of the
    uint8 grey Mat (src/lib.rs:918-920, src/utils.rs:204-211) —
    resizing in float would drift from the oracle by up to 1 LSB.

    uint16 bursts solve on their high-byte reduction (bit-identical
    warps to the equivalent 8-bit burst; see color.depth_reduce_u8) —
    only the stacking stage sees the full depth."""
    grey = color.rgb_to_gray_u8(color.depth_reduce_u8(frames_u8))
    if scale_hw is not None:
        grey = resize.resize(grey, scale_hw, interpolation=3)
    return grey.astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("scale_hw",))
def _ecc_mask_jit(mask, scale_hw: Optional[tuple] = None):
    """Binarise the user's reference-frame mask (nonzero = valid) and,
    on the scaled path, shrink it conservatively to the solve grid (a
    scaled pixel stays valid only if >= half its INTER_AREA footprint
    was)."""
    m = (mask > 0).astype(jnp.float32)
    if scale_hw is not None:
        m = (resize.resize(m, scale_hw, interpolation=3) >= 0.5).astype(
            jnp.float32
        )
    return m


@functools.partial(jax.jit, static_argnames=("motion_type", "scale_hw"))
def _ecc_warp_accumulate_jit(
    frames_u8: jnp.ndarray,
    warps: jnp.ndarray,
    oks: jnp.ndarray,
    motion_type: MotionType,
    scale_hw: Optional[tuple] = None,
):
    """Stage 3: rescale warps if estimated on scaled greys
    (ref src/lib.rs:941-958), warp every frame onto frame 0's grid
    (forward application, BORDER_CONSTANT 0 — ref src/lib.rs:780-803),
    masked sum over frames."""
    h, w = frames_u8.shape[1], frames_u8.shape[2]
    if scale_hw is not None:
        warps = _adjust_warp_for_scale(warps, motion_type, scale_hw, (h, w))
    # failed lanes contribute nothing; keep their (frozen, finite) warps
    # out of the kernel anyway in case of NaN
    eye = jnp.eye(3, dtype=warps.dtype)[: warps.shape[1]]
    warps = jnp.where(oks[:, None, None], warps, eye)
    perspective = motion_type == MotionType.Homography
    # the RAW burst is widened frame by frame inside the accumulation
    return color.to_unit_f32(frames_u8[0]) + warp_accumulate_rgb(
        frames_u8[1:], warps, oks, perspective=perspective,
    )


def _stream_sigma_stack(
    files,
    mats_full: np.ndarray,  # [N-1,2|3,3] full-res forward maps, frames 1..
    oks: np.ndarray,  # [N-1] bool
    perspective: bool,
    kappa: float,
    iters: int,
    chunk_size: int,
    hw,
    preserve_depth: bool = False,
    mesh=None,
    ckpt=None,
    checkpoint_every: int = 4,
    align_save: Optional[dict] = None,
    resume: Optional[dict] = None,
):
    """Streaming kappa-sigma stack (r3 VERDICT item 6): the S0/S1/S2
    moment accumulators of ops/stack.py stream over decoded chunks
    as-is — only the per-pixel moments stay resident, never a warped
    burst.  The caller has already solved the warps (one align pass);
    this function re-decodes the files ``1 + iters`` more times (one
    re-warp sweep per moment pass, ops/stack.clip_iterate is the single
    source of truth for the clip semantics).

    ``mesh`` (r4 VERDICT item 3, stream x mesh): each chunk's re-warp
    sweep runs sharded over the 'data' axis and its moments psum
    (``parallel.mesh._stream_moments_program``); ``chunk_size`` must
    then be a multiple of the data-axis size (the stream entry points
    round it up).

    Checkpoint/resume (r4 VERDICT item 9): ``ckpt``
    (utils.checkpoint.StreamCheckpoint) makes the multi-pass sweep
    schedule resumable — every ``checkpoint_every`` chunks the current
    pass index, chunk cursor, partial accumulators and the pass's
    entry state are written (phase=1 records; ``align_save`` carries
    the align pass's products so a resumed run never re-solves).
    ``resume`` is the state dict a phase=1 checkpoint load produced:
    {pass_idx, cursor, part, base, total_s0}.

    Returns ``(image [H,W,3] f32, clipped_sample_frac)``.
    """
    from ..ops import stack as stack_ops

    h, w = int(hw[0]), int(hw[1])
    eye = np.eye(3, dtype=np.float32)
    mats3 = np.asarray(mats_full, np.float32)
    if mats3.shape[-2] == 2:
        mats3 = np.concatenate(
            [mats3, np.tile(eye[2:][None], (mats3.shape[0], 1, 1))], axis=1
        )
    oks_all = np.concatenate([[True], np.asarray(oks, bool)])
    mats_all = np.concatenate([eye[None], mats3], axis=0)
    mats_all[~oks_all] = eye  # NaN matrices must not reach linalg.inv
    kw = dict(perspective=perspective)
    # pad the lane tables once to whole chunks (pad lanes: ok=False)
    n_all = mats_all.shape[0]
    pad = (-n_all) % chunk_size
    if pad:
        mats_all = np.concatenate(
            [mats_all, np.tile(eye[None], (pad, 1, 1))]
        )
        oks_all = np.concatenate([oks_all, np.zeros(pad, bool)])
    mats_j = jnp.asarray(mats_all)
    oks_j = jnp.asarray(oks_all)
    mom_prog = clip_prog = None
    if mesh is not None:
        from ..parallel import mesh as pmesh

        mom_prog = pmesh._stream_moments_program(mesh, perspective, False)
        clip_prog = pmesh._stream_moments_program(mesh, perspective, True)

    # resumable sweep bookkeeping: which pass is running (0 = initial
    # moments, 1..iters = clip sweeps), the state ENTERING the current
    # clip pass (for mid-pass checkpoints), and the pass-0 total sample
    # count (the clip-fraction base, unavailable after a resume)
    cell = {"pass": 0, "base": None, "total_s0": None}
    if resume is not None:
        cell["total_s0"] = resume.get("total_s0")

    def save_state(cursor, acc):
        state = dict(
            phase=np.int64(1),
            pass_idx=np.int64(cell["pass"]),
            part0=np.asarray(acc[0]), part1=np.asarray(acc[1]),
            part2=np.asarray(acc[2]),
            has_base=np.int64(cell["base"] is not None),
            total_s0=np.float64(cell["total_s0"] or 0.0),
        )
        if cell["base"] is not None:
            b = cell["base"]
            state.update(
                base0=np.asarray(b[0]), base1=np.asarray(b[1]),
                base2=np.asarray(b[2]),
            )
        if align_save:
            state.update({f"al_{k}": v for k, v in align_save.items()})
        ckpt.save(cursor, **state)

    def sweep(fn, *extra):
        acc = None
        start_chunk = 0
        if (resume is not None and resume["pass_idx"] == cell["pass"]
                and resume.get("part") is not None):
            start_chunk = int(resume["cursor"])
            acc = tuple(jnp.asarray(x) for x in resume["part"])
        s0_lane = start_chunk * chunk_size
        chunk_i = start_chunk
        for frames in io.prefetched_chunks(
            files, chunk_size, h, w, start=start_chunk * chunk_size,
            preserve_depth=preserve_depth,
        ):
            n_real = frames.shape[0]
            padded = io.pad_chunk(frames, chunk_size)
            sl = slice(s0_lane, s0_lane + chunk_size)
            if mesh is not None:
                from ..parallel import mesh as pmesh

                prog = (
                    clip_prog if fn is stack_ops._clipped_chunk
                    else mom_prog
                )
                part = prog(
                    pmesh.shard_frames(jnp.asarray(padded), mesh),
                    mats_all[sl], oks_all[sl], *extra,
                )
            else:
                frames_j = jax.device_put(padded)
                part = fn(frames_j, mats_j[sl], oks_j[sl], *extra, **kw)
            acc = part if acc is None else tuple(
                a + p for a, p in zip(acc, part)
            )
            s0_lane += n_real
            chunk_i += 1
            more = s0_lane < n_all
            if ckpt is not None and more and (
                chunk_i % max(checkpoint_every, 1) == 0
            ):
                save_state(chunk_i, acc)
        return acc

    def clip_cb(mu, tol):
        res = sweep(stack_ops._clipped_chunk, mu, tol)
        cell["pass"] += 1
        return res

    def pass_hook(i, s0c, s1, s2):
        # state entering clip pass i (recorded so a mid-pass checkpoint
        # of pass i can recompute its mu/tol on resume)
        cell["base"] = (s0c, s1, s2)

    if resume is not None and int(resume["pass_idx"]) >= 1:
        cell["pass"] = int(resume["pass_idx"])
        entry = tuple(jnp.asarray(x) for x in resume["base"])
        cell["base"] = entry
        out, kept = stack_ops.clip_iterate(
            None, None, None, kappa, iters, clip_cb,
            start_pass=cell["pass"], entry_state=entry,
            pass_hook=pass_hook,
        )
        ts = float(cell["total_s0"] or 0.0)
    else:
        s0, s1, s2 = sweep(stack_ops._moments_chunk)
        cell["total_s0"] = float(jax.device_get(jnp.sum(s0)))
        cell["pass"] = 1
        s0c = s0[..., None] if s0.ndim == s1.ndim - 1 else s0
        cell["base"] = (s0c, s1, s2)
        out, kept = stack_ops.clip_iterate(
            s0, s1, s2, kappa, iters, clip_cb, pass_hook=pass_hook,
        )
        ts = cell["total_s0"]
    tk = float(jax.device_get(jnp.sum(kept)))
    kept_frac = tk / max(ts * 3.0, 1.0)
    return np.asarray(out), max(0.0, 1.0 - kept_frac)


def ecc_stack_step_graph(
    frames_u8: jnp.ndarray,
    motion_type: MotionType,
    num_iters: int,
    eps: float,
    gauss_filt_size: int,
):
    """Fully in-graph align+stack step (jittable end to end) — used for
    compile checks and small workloads; production pipelines go through
    the host driver in :func:`ecc_match_arrays`."""
    n, h, w = frames_u8.shape[0], frames_u8.shape[1], frames_u8.shape[2]
    grey = color.rgb_to_gray_u8(
        color.depth_reduce_u8(frames_u8)
    ).astype(jnp.float32)
    result = ecc_ops.find_transform_ecc_batched_graph(
        grey[1:], grey[0],
        motion_type=motion_type, num_iters=num_iters, eps=eps,
        gauss_filt_size=gauss_filt_size,
    )
    stacked_sum = _ecc_warp_accumulate_jit(
        frames_u8, result.warp_matrix, result.ok, motion_type=motion_type
    )
    return stacked_sum, result.ok, result.rho, result.num_iters


def _resolve_mesh(mesh):
    """Resolve the public ``mesh=`` argument: ``None`` -> single-device
    pipeline; ``"auto"`` -> a data-axis mesh over every visible device
    (single-device pipeline when there is only one); a
    ``jax.sharding.Mesh`` (with a 'data' axis) passes through.  This is
    how the reference's parallelism surfaces too — inside the public
    entry points, invisible to the caller (Rayon fan-out at
    src/lib.rs:188, 746), not as a separate orchestration layer."""
    if mesh is None:
        return None
    if isinstance(mesh, str):
        if mesh != "auto":
            raise InvalidParamsError(
                f"mesh must be None, 'auto' or a jax.sharding.Mesh, "
                f"got {mesh!r}"
            )
        if jax.device_count() <= 1:
            return None
        from ..parallel import mesh as pmesh

        return pmesh.make_mesh(jax.devices())
    if "data" not in getattr(mesh, "axis_names", ()):
        raise InvalidParamsError(
            "mesh must have a 'data' axis (parallel.make_mesh builds one)"
        )
    return mesh


def _pad_burst(frames, ndata: int):
    """Pad the frame axis to a multiple of the data-axis size with
    copies of frame 0 (their lanes converge instantly and are excluded
    from the result via lane_valid).  Device-resident bursts pad on
    device (no host round-trip)."""
    n = frames.shape[0]
    pad = (-n) % ndata
    if pad == 0:
        return frames, np.ones(n, bool)
    xp = jnp if isinstance(frames, jax.Array) else np
    frames_p = xp.concatenate(
        [frames, xp.repeat(frames[:1], pad, axis=0)]
    )
    return frames_p, np.arange(n + pad) < n


def _ecc_match_arrays_sharded(
    frames: np.ndarray,
    params: EccMatchParameters,
    scale_hw,
    on_failure: str,
    return_stats: bool,
    mask,
    mesh,
    device_output: bool = False,
):
    """Multi-chip ``ecc_match_arrays``: the whole align+stack step runs
    as ONE shard_map program over the mesh's 'data' axis
    (parallel.ecc_stack_step) with full feature parity — scale-down,
    coarse-to-fine, alignment masks, uint16, sigma-clip.  Return
    semantics are identical to the single-device path."""
    from ..parallel import mesh as pmesh

    n, h, w = frames.shape[:3]
    num_iters, eps = params.resolve_criteria()
    input_mask = None
    if mask is not None:
        mask = np.asarray(mask)
        if mask.ndim == 3 and mask.shape[-1] == 1:
            mask = mask[..., 0]
        if mask.shape != (h, w):
            raise InvalidParamsError(
                f"mask must be [H,W] matching the frames, got {mask.shape}"
                f" for frames {(h, w)}"
            )
        input_mask = _ecc_mask_jit(jnp.asarray(mask), scale_hw=scale_hw)
    ndata = mesh.shape["data"]
    frames_p, lane_valid = _pad_burst(frames, ndata)
    frames_j = pmesh.shard_frames(jnp.asarray(frames_p), mesh)
    ref_grey = _ecc_grey_jit(jnp.asarray(frames[:1]), scale_hw=scale_hw)[0]
    sigma = getattr(params, "stacking", "mean") == "sigma_clip"
    sr_factor = getattr(params, "output_scale", 1)
    total, ok_j, rho_j, iters_j = pmesh.ecc_stack_step(
        frames_j,
        ref_grey,
        mesh,
        motion_type=params.motion_type,
        num_iters=num_iters,
        eps=eps,
        gauss_filt_size=params.gauss_filt_size,
        phase_init=getattr(params, "phase_init", False),
        stacking=getattr(params, "stacking", "mean"),
        sigma_kappa=params.sigma_kappa,
        sigma_iters=params.sigma_iters,
        scale_hw=scale_hw,
        coarse_levels=getattr(params, "coarse_levels", 0),
        input_mask=input_mask,
        lane_valid=jnp.asarray(lane_valid),
        return_extras=True,
        output_scale=sr_factor,
        mode=_solver_mode(params),
    )
    ok = np.asarray(ok_j)[:n]
    stats = None
    if return_stats:
        from ..utils.tracing import PipelineStats

        stats = PipelineStats(
            frames_total=n,
            frames_kept=int(ok.sum()),
            frames_dropped=int((~ok).sum()),
            ecc_iterations=np.asarray(iters_j)[1:n].tolist(),
            ecc_rho=np.asarray(rho_j)[1:n].tolist(),
        )
    if not ok.all():
        bad = np.nonzero(~ok)[0]
        if on_failure == "raise":
            raise ProcessingError(
                "findTransformECC failed to converge for frames "
                f"{bad.tolist()}"
            )
    kept = int(ok.sum())
    fetch = (lambda x: x) if device_output else np.asarray
    final = sigma or sr_factor > 1  # already a finalised image
    out = fetch(total) if final else fetch(total) / max(kept, 1)
    return (out, stats) if return_stats else out


def ecc_match_arrays(
    frames: np.ndarray,
    params: EccMatchParameters,
    scale_down_width: Optional[float] = None,
    on_failure: str = "raise",
    return_stats: bool = False,
    mask: Optional[np.ndarray] = None,
    mesh=None,
    device_output: bool = False,
):
    """Array-based ``ecc_match``: ``frames`` is ``[N,H,W,3] uint8`` RGB
    (numpy, staged to device memory once — or a device-resident
    ``jax.Array``, used in place with no re-upload).
    ``device_output=True`` returns the stacked image as a ``jax.Array``
    still on the device (no D2H materialisation — compose with further
    device-side processing).

    Returns the stacked ``[H,W,3] float32`` RGB image in [0,1]
    (frame 0's grid), like the reference returns a CV_32F Mat
    (src/lib.rs:836-846).  With ``params.output_scale = f > 1`` the
    output grid is ``[f*H, f*W, 3]`` (super-resolution stack).

    ``mask`` ([H,W], nonzero = valid) excludes reference-frame pixels
    from the alignment (cv2.findTransformECC's ``inputMask`` — frame 0
    is the ECC input image in this pipeline's convention): moving
    subjects, lens dirt or dead sensor regions stop perturbing the
    solved warps.  Stacking is unaffected — every output pixel still
    averages all frames.  Masked solves disable the phase-correlation
    warm start (the whole-frame FFT would see the masked content) and
    run identity-initialised like OpenCV.

    ``mesh``: ``None`` (single device), ``"auto"`` (shard the frame
    axis over every visible device when there is more than one — the
    reference's invisible-in-API parallelism, src/lib.rs:746), or a
    ``jax.sharding.Mesh`` with a 'data' axis
    (``libstacker_tpu.parallel.make_mesh``).  Multi-chip runs keep
    full feature parity (scale-down, coarse-to-fine, masks, uint16,
    sigma-clip) except super-resolution (``output_scale > 1``), which
    raises.
    """
    params.validate()
    if not isinstance(frames, jax.Array):
        # device-resident bursts pass through untouched (np.asarray on
        # a jax.Array is a full D2H download; callers that already
        # staged the burst on the device keep it there)
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
    num_iters, eps = params.resolve_criteria()

    scale_hw = None
    if scale_down_width is not None:
        if scale_down_width >= w:
            raise InvalidParamsError(
                "scale_down_to was larger (or equal) to the full image "
                f"width: full_size:{w}, scale_down_to:{scale_down_width}"
            )
        if scale_down_width <= 10.0:
            raise InvalidParamsError(
                f"scale_down_to was too small scale_down_to:{scale_down_width}"
            )
        scale_hw = resize.scale_image_size(h, w, scale_down_width)

    if n == 1:
        # reference: stacked = sum / 1 = frame 0 (src/lib.rs:836-843)
        from .keypoint import _single_frame_out

        out = _single_frame_out(frames[0], params)
        if return_stats:
            from ..utils.tracing import PipelineStats

            return out, PipelineStats(frames_total=1, frames_kept=1,
                                      frames_dropped=0)
        return out

    mesh = _resolve_mesh(mesh)
    if mesh is not None:
        return _ecc_match_arrays_sharded(
            frames, params, scale_hw, on_failure, return_stats, mask,
            mesh, device_output,
        )

    frames_j = jnp.asarray(frames)
    grey = _ecc_grey_jit(frames_j, scale_hw=scale_hw)
    input_mask = None
    if mask is not None:
        mask = np.asarray(mask)
        if mask.ndim == 3 and mask.shape[-1] == 1:
            mask = mask[..., 0]
        if mask.shape != (h, w):
            raise InvalidParamsError(
                f"mask must be [H,W] matching the frames, got {mask.shape}"
                f" for frames {(h, w)}"
            )
        input_mask = _ecc_mask_jit(jnp.asarray(mask), scale_hw=scale_hw)
    warp_init = None
    if getattr(params, "phase_init", False) and input_mask is None:
        from ..ops import phasecorr

        warp_init = phasecorr.phase_init_warps(
            grey[1:], grey[0], motion_type=params.motion_type,
            rotation=getattr(params, "phase_init_rotation", False),
        )
    result = ecc_ops.find_transform_ecc_batched(
        grey[1:],
        grey[0],
        motion_type=params.motion_type,
        num_iters=num_iters,
        eps=eps,
        gauss_filt_size=params.gauss_filt_size,
        coarse_levels=getattr(params, "coarse_levels", 0),
        warp_init=warp_init,
        mode=_solver_mode(params),
        input_mask=input_mask,
    )
    sigma = getattr(params, "stacking", "mean") == "sigma_clip"
    sr_factor = getattr(params, "output_scale", 1)
    if sr_factor > 1:
        # beyond-reference super-resolution stack (ops/stack.py)
        from ..ops import stack as stack_ops

        warps_full = jnp.asarray(result.warp_matrix)
        if scale_hw is not None:
            warps_full = _adjust_warp_for_scale(
                warps_full, params.motion_type, scale_hw, (h, w)
            )
        stacked_img = stack_ops.super_res_stack(
            frames_j, warps_full, result.ok, factor=sr_factor,
            perspective=params.motion_type == MotionType.Homography,
        )
    elif sigma:
        # beyond-reference robust stack (ops/stack.py): per-pixel
        # kappa-sigma outlier rejection over the re-warped burst
        from ..ops import stack as stack_ops

        warps_full = jnp.asarray(result.warp_matrix)
        if scale_hw is not None:
            warps_full = _adjust_warp_for_scale(
                warps_full, params.motion_type, scale_hw, (h, w)
            )
        stacked_img, clip_frac = stack_ops.kappa_sigma_stack(
            frames_j, warps_full, result.ok,
            perspective=params.motion_type == MotionType.Homography,
            kappa=params.sigma_kappa, iters=params.sigma_iters,
        )
    else:
        stacked_sum = _ecc_warp_accumulate_jit(
            frames_j,
            result.warp_matrix,
            result.ok,
            motion_type=params.motion_type,
            scale_hw=scale_hw,
        )
    ok = np.asarray(result.ok)
    stats = None
    if return_stats:
        from ..utils.tracing import PipelineStats

        stats = PipelineStats(
            frames_total=n,
            frames_kept=1 + int(ok.sum()),
            frames_dropped=int((~ok).sum()),
            ecc_iterations=np.asarray(result.num_iters).tolist(),
            ecc_rho=np.asarray(result.rho).tolist(),
            clipped_sample_frac=clip_frac if sigma else None,
        )
    fetch = (lambda x: x) if device_output else np.asarray
    if not ok.all():
        bad = np.nonzero(~ok)[0] + 1
        if on_failure == "raise":
            raise ProcessingError(
                "findTransformECC failed to converge for frames "
                f"{bad.tolist()} (NaN correlation or non-positive lambda "
                "denominator)"
            )
        if sigma or sr_factor > 1:  # failed lanes already excluded
            out = fetch(stacked_img)
            return (out, stats) if return_stats else out
        # drop mode: failed frames contributed nothing to the sum
        count = 1 + int(ok.sum())
        out = fetch(stacked_sum) / count
        return (out, stats) if return_stats else out
    out = (
        fetch(stacked_img)
        if (sigma or sr_factor > 1)
        else fetch(stacked_sum) / n
    )
    return (out, stats) if return_stats else out


def ecc_match(
    files: Sequence,
    params: EccMatchParameters,
    scale_down_width: Optional[float] = None,
    on_failure: str = "raise",
    return_stats: bool = False,
    mask: Optional[np.ndarray] = None,
    preserve_depth: bool = False,
    mesh=None,
):
    """Align and stack image files with ECC (ref src/lib.rs:702-717).

    Returns the stacked ``[H,W,3] float32`` RGB image in [0,1]
    (plus a PipelineStats record when ``return_stats``).  ``mask``
    excludes reference-frame pixels from the alignment (see
    :func:`ecc_match_arrays`).  ``preserve_depth`` decodes 16-bit
    files to uint16 and stacks at full depth (alignment is unchanged;
    pair with ``utils.io.save_image(..., bit_depth=16)``).  ``mesh``
    shards the burst over multiple chips (see
    :func:`ecc_match_arrays`).
    """
    frames = io.load_frames(files, preserve_depth=preserve_depth)
    return ecc_match_arrays(
        frames, params, scale_down_width, on_failure, return_stats,
        mask=mask, mesh=mesh,
    )


def ecc_match_stream(
    files: Sequence,
    params: EccMatchParameters,
    scale_down_width: Optional[float] = None,
    chunk_size: int = 16,
    on_failure: str = "raise",
    mask: Optional[np.ndarray] = None,
    preserve_depth: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 4,
    return_stats: bool = False,
    mesh=None,
):
    """Streaming ``ecc_match`` for bursts larger than HBM: frames are
    decoded, aligned and accumulated in chunks of ``chunk_size`` against
    frame 0; only the running sum stays resident (the reference's
    "memory efficient streaming processing" claim, src/lib.rs:106,
    realised as chunked device accumulation — SURVEY.md §5
    checkpoint/streaming note).  Chunks are host-decoded one step ahead
    on a background thread, and the final partial chunk is padded to
    ``chunk_size`` so no per-burst-length recompile ever happens.

    ``checkpoint_path`` makes the run RESUMABLE: every
    ``checkpoint_every`` chunks the accumulator + ok flags are written
    atomically (utils.checkpoint), and a rerun of the same burst picks
    up at the last saved chunk instead of frame 0.  The file is keyed
    to the file list/params/mask (a mismatched checkpoint is ignored)
    and removed on success.  Each save syncs the device accumulator —
    pick ``checkpoint_every`` high enough that the sync cost amortises.

    ``params.stacking = "sigma_clip"`` streams too (long bursts are
    exactly where kappa-sigma matters — satellite trails over 100+
    frames — and where HBM forces streaming): the align pass solves
    and stores the (tiny) warp matrices, then the moment accumulators
    of ops/stack.py stream over ``1 + sigma_iters`` extra decode
    passes (see :func:`_stream_sigma_stack`).

    ``mesh`` (r4 VERDICT item 3): streaming COMPOSES with multi-chip —
    each chunk is sharded over the mesh's 'data' axis (solve slabs +
    psum'd stacking through the same programs the whole-burst mesh
    path uses; sigma-clip moment sweeps psum per chunk), so
    bigger-than-HBM bursts can use every chip.  ``chunk_size`` is
    rounded up to a multiple of the data-axis size.
    """
    params.validate()
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
    files = io.normalize_files(files)
    if not files:
        raise NotEnoughFilesError()
    num_iters, eps = params.resolve_criteria()

    ref = io.load_frames(files[:1], preserve_depth=preserve_depth)
    n_total = len(files)
    h, w = ref.shape[1:3]
    scale_hw = None
    if scale_down_width is not None:
        if scale_down_width >= w:
            raise InvalidParamsError(
                "scale_down_to was larger (or equal) to the full image "
                f"width: full_size:{w}, scale_down_to:{scale_down_width}"
            )
        if scale_down_width <= 10.0:
            raise InvalidParamsError(
                f"scale_down_to was too small scale_down_to:{scale_down_width}"
            )
        scale_hw = resize.scale_image_size(h, w, scale_down_width)

    ref_j = jnp.asarray(ref)
    ref_grey = _ecc_grey_jit(ref_j, scale_hw=scale_hw)[0]
    input_mask = None
    if mask is not None:
        mask = np.asarray(mask)
        if mask.ndim == 3 and mask.shape[-1] == 1:
            mask = mask[..., 0]
        if mask.shape != (h, w):
            raise InvalidParamsError(
                f"mask must be [H,W] matching the frames, got {mask.shape}"
                f" for frames {(h, w)}"
            )
        input_mask = _ecc_mask_jit(jnp.asarray(mask), scale_hw=scale_hw)
    acc = color.to_unit_f32(ref_j[0])
    all_ok = []
    all_iters = []
    all_rho = []
    all_warps = []
    ckpt = None
    chunks_done = 0
    sigma_resume = None
    align_done = False
    if checkpoint_path is not None:
        from ..utils import checkpoint as ckpt_mod

        ckpt = ckpt_mod.StreamCheckpoint(
            checkpoint_path,
            ckpt_mod.burst_key(files, params, scale_down_width,
                               chunk_size, extra="ecc", mask=mask),
        )
        chunks_done, state = ckpt.load()
        if state is not None and int(state.get("phase", 0)) == 1:
            # sigma-clip sweep phase (r4 VERDICT item 9): the align
            # pass is complete — restore its products and resume inside
            # the moment sweeps
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
            all_warps.append(state["al_warps"].astype(np.float32))
            all_ok.append(state["al_ok"].astype(bool))
            all_iters.append(state["al_iters"])
            all_rho.append(state["al_rho"])
            align_done = True
            chunks_done = 0
        elif state is not None and chunks_done > 0:
            if "acc" in state:
                acc = jnp.asarray(state["acc"])
            if state["ok"].size:
                all_ok.append(state["ok"].astype(bool))
            if state.get("iters") is not None and state["iters"].size:
                all_iters.append(state["iters"])
                all_rho.append(state["rho"])
            if sigma and state.get("warps") is not None \
                    and state["warps"].size:
                all_warps.append(state["warps"].astype(np.float32))

    def save_align():
        st = dict(
            ok=np.concatenate(all_ok),
            iters=np.concatenate(all_iters),
            rho=np.concatenate(all_rho),
        )
        if sigma:
            st["warps"] = (
                np.concatenate(all_warps) if all_warps
                else np.zeros((0, 3, 3), np.float32)
            )
        else:
            st["acc"] = np.asarray(acc)
        ckpt.save(chunks_done, **st)
    # True async H2D double-buffering (SURVEY §7 phase 6): the NEXT
    # chunk's device_put is issued before this chunk's solve dispatches,
    # so the upload rides the transfer engine while the solve runs
    # (decode-ahead already overlaps on a host thread in
    # io.prefetched_chunks).  Tail pads are the REFERENCE frame, whose
    # lanes converge in ~2 iterations (see io.pad_chunk).
    gen = iter(()) if align_done else io.prefetched_chunks(
        files, chunk_size, h, w, start=1 + chunks_done * chunk_size,
        preserve_depth=preserve_depth,
    )

    def put_next():
        frames = next(gen, None)
        if frames is None:
            return None
        padded = io.pad_chunk(frames, chunk_size, fill=ref[0])
        if mesh is not None:
            from ..parallel import mesh as pmesh

            return pmesh.shard_frames(jnp.asarray(padded), mesh), \
                frames.shape[0]
        return jax.device_put(padded), frames.shape[0]

    cur = put_next()
    while cur is not None:
        frames_j, n_real = cur
        cur = put_next()
        if mesh is not None:
            from ..parallel import mesh as pmesh

            real_np = np.arange(chunk_size) < n_real
            if sigma:
                # align only; the moment sweeps run sharded later
                warps_np, rho_np, iters_np, ok_np = \
                    pmesh._ecc_solve_sharded(
                        frames_j, ref_grey, mesh,
                        motion_type=params.motion_type,
                        num_iters=num_iters, eps=eps,
                        gauss_filt_size=params.gauss_filt_size,
                        phase_init=(
                            getattr(params, "phase_init", False)
                            and input_mask is None
                        ),
                        scale_hw=scale_hw,
                        coarse_levels=getattr(params, "coarse_levels", 0),
                        input_mask=input_mask,
                        mode=_solver_mode(params),
                    )
                m = warps_np.astype(np.float32)
                if scale_hw is not None:
                    m = np.asarray(_adjust_warp_for_scale(
                        jnp.asarray(m), params.motion_type, scale_hw,
                        (h, w),
                    ))
                all_warps.append(m[:n_real])
            else:
                total, ok_np, rho_np, iters_np = pmesh.ecc_stack_step(
                    frames_j, ref_grey, mesh,
                    motion_type=params.motion_type,
                    num_iters=num_iters, eps=eps,
                    gauss_filt_size=params.gauss_filt_size,
                    phase_init=getattr(params, "phase_init", False),
                    stacking="mean", scale_hw=scale_hw,
                    coarse_levels=getattr(params, "coarse_levels", 0),
                    input_mask=input_mask,
                    lane_valid=jnp.asarray(real_np),
                    return_extras=True,
                    mode=_solver_mode(params),
                )
                acc = acc + total
                rho_np = np.asarray(rho_np)
                iters_np = np.asarray(iters_np)
            all_ok.append(np.asarray(ok_np, bool)[:n_real])
            all_iters.append(np.asarray(iters_np)[:n_real])
            all_rho.append(np.asarray(rho_np)[:n_real])
            chunks_done += 1
            if ckpt is not None and (
                chunks_done % max(checkpoint_every, 1) == 0 or cur is None
            ):
                save_align()
            continue
        grey = _ecc_grey_jit(frames_j, scale_hw=scale_hw)
        warp_init = None
        if getattr(params, "phase_init", False) and input_mask is None:
            from ..ops import phasecorr

            warp_init = phasecorr.phase_init_warps(
                grey, ref_grey, motion_type=params.motion_type,
                rotation=getattr(params, "phase_init_rotation", False),
            )
        result = ecc_ops.find_transform_ecc_batched(
            grey,
            ref_grey,
            motion_type=params.motion_type,
            num_iters=num_iters,
            eps=eps,
            gauss_filt_size=params.gauss_filt_size,
            coarse_levels=getattr(params, "coarse_levels", 0),
            warp_init=warp_init,
            mode=_solver_mode(params),
            input_mask=input_mask,
        )
        real = jnp.arange(chunk_size) < n_real
        ok_lane = result.ok & real
        if sigma:
            # sigma-clip streams its moment passes AFTER the align
            # pass: just store this chunk's (tiny) full-res warps
            warps = result.warp_matrix
            if scale_hw is not None:
                warps = _adjust_warp_for_scale(
                    warps, params.motion_type, scale_hw, (h, w)
                )
            all_warps.append(np.asarray(warps)[:n_real])
        else:
            warps = result.warp_matrix
            if scale_hw is not None:
                warps = _adjust_warp_for_scale(
                    warps, params.motion_type, scale_hw, (h, w)
                )
            acc = acc + warp_accumulate_rgb(
                frames_j, warps, ok_lane,
                perspective=params.motion_type == MotionType.Homography,
            )
        all_ok.append(np.asarray(result.ok)[:n_real])
        all_iters.append(np.asarray(result.num_iters)[:n_real])
        all_rho.append(np.asarray(result.rho)[:n_real])
        chunks_done += 1
        if ckpt is not None and (
            chunks_done % max(checkpoint_every, 1) == 0 or cur is None
        ):
            save_align()

    ok = np.concatenate(all_ok) if all_ok else np.zeros(0, bool)
    if ckpt is not None and not sigma:
        ckpt.remove()  # completed — the checkpoint has served its job
    if not ok.all():
        bad = np.nonzero(~ok)[0] + 1
        if on_failure == "raise":
            raise ProcessingError(
                f"findTransformECC failed to converge for frames {bad.tolist()}"
            )
    clip_frac = None
    if sigma:
        mats_np = (
            np.concatenate(all_warps) if all_warps
            else np.zeros((0, 3, 3), np.float32)
        )
        out, clip_frac = _stream_sigma_stack(
            files, mats_np, ok,
            perspective=params.motion_type == MotionType.Homography,
            kappa=params.sigma_kappa, iters=params.sigma_iters,
            chunk_size=chunk_size, hw=(h, w),
            preserve_depth=preserve_depth, mesh=mesh,
            ckpt=ckpt, checkpoint_every=checkpoint_every,
            align_save=(
                dict(
                    warps=mats_np, ok=ok,
                    iters=(np.concatenate(all_iters) if all_iters
                           else np.zeros(0, np.int32)),
                    rho=(np.concatenate(all_rho) if all_rho
                         else np.zeros(0, np.float32)),
                )
                if ckpt is not None else None
            ),
            resume=sigma_resume,
        )
        if ckpt is not None:
            ckpt.remove()
    else:
        count = 1 + int(ok.sum()) if not ok.all() else n_total
        out = np.asarray(acc) / count
    stats = None
    if return_stats:
        from ..utils.tracing import PipelineStats

        stats = PipelineStats(
            frames_total=n_total,
            frames_kept=1 + int(ok.sum()),
            frames_dropped=int((~ok).sum()),
            ecc_iterations=np.concatenate(all_iters).tolist()
            if all_iters else [],
            ecc_rho=np.concatenate(all_rho).tolist() if all_rho else [],
            clipped_sample_frac=clip_frac,
        )
    return (out, stats) if return_stats else out

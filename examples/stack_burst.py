"""End-to-end burst stacking example — the reference workflow
(ref examples/main.rs:27-160), on an accelerator:

1. scan a directory for jpg/jpeg/tif/png frames;
2. score all four sharpness metrics for every frame in ONE batched
   device program (vs the reference's Rayon loop, examples/main.rs:37-49);
3. sort ascending by Tenengrad, print the table, drop the worst frame,
   reverse so the sharpest frame becomes the reference (frame 0);
4. run the selected pipeline variants (keypoint full/scaled, ECC
   full/scaled — all four by default) with phase timings;
5. save the stacked images as PNGs (no GUI on accelerator hosts).

Usage:  python examples/stack_burst.py <image_dir> [--out outdir]
        [--method keypoint|ecc|all] [--motion-type homography|...]
        [--max-count N] [--epsilon E] [--gauss-filt-size K]
        [--ransac-reproj-threshold T] [--match-ratio R]
        [--match-keep-ratio R] [--scale-width W] [--no-scaled/--no-full]
        [--keep-all] [--stream N] [--ecc-solver forward|lazy|ic]
        [--no-phase-init] [--phase-init-rotation] [--coarse-levels N]
        [--stacking mean|sigma_clip] [--sigma-kappa K] [--sigma-iters I]
        [--output-scale 1|2|3|4] [--align-mask PATH] [--out-depth 8|16]
        [--preserve-depth] [--checkpoint PATH]

(The reference's README lists CLI options as an unfinished todo,
README.md:85 — these flags cover every field of both parameter structs.)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def save_png(path, img_f32_rgb, bit_depth=8):
    from libstacker_tpu.utils import io

    io.save_image(path, np.asarray(img_f32_rgb), bit_depth=bit_depth)


def main():
    ap = argparse.ArgumentParser(
        description="Align and stack a burst of photos (sharpness-ranked "
        "reference frame, keypoint and/or ECC alignment)."
    )
    ap.add_argument("image_dir")
    ap.add_argument("--out", default="stacked_out")
    ap.add_argument("--scale-width", type=float, default=400.0,
                    help="scale-down width for the scaled variants")
    ap.add_argument("--method", choices=("keypoint", "ecc", "all"),
                    default="all", help="which pipeline(s) to run")
    ap.add_argument("--no-full", action="store_true",
                    help="skip the full-resolution variants")
    ap.add_argument("--no-scaled", action="store_true",
                    help="skip the scale-down variants")
    ap.add_argument("--keep-all", action="store_true",
                    help="do not drop the least-sharp frame")
    ap.add_argument("--stream", type=int, default=0, metavar="CHUNK",
                    help="stream in chunks of CHUNK frames (bounded HBM) "
                    "instead of whole-burst processing")
    ap.add_argument("--checkpoint", metavar="PATH", default=None,
                    help="(with --stream) write a resumable checkpoint "
                    "here every few chunks; rerunning the same command "
                    "after a crash resumes from the last saved chunk")
    # KeyPointMatchParameters (ref src/lib.rs:49-73)
    ap.add_argument("--homography-method", choices=("ransac", "lmeds"),
                    default="ransac")
    ap.add_argument("--ransac-reproj-threshold", type=float, default=5.0)
    ap.add_argument("--match-ratio", type=float, default=0.9)
    ap.add_argument("--match-keep-ratio", type=float, default=0.80)
    ap.add_argument("--border-mode", type=int, default=0,
                    help="cv2 BORDER_* integer for the keypoint warp")
    ap.add_argument("--max-iters", type=int, default=2000,
                    help="RANSAC hypothesis budget (cv2 maxIters)")
    ap.add_argument("--confidence", type=float, default=0.995)
    # EccMatchParameters (ref src/lib.rs:611-623)
    ap.add_argument("--motion-type",
                    choices=("translation", "euclidean", "affine",
                             "homography"),
                    default="homography")
    ap.add_argument("--max-count", type=int, default=5000)
    ap.add_argument("--epsilon", type=float, default=1e-5)
    ap.add_argument("--gauss-filt-size", type=int, default=5)
    ap.add_argument("--no-phase-init", action="store_true",
                    help="disable the phase-correlation ECC warm start "
                    "(strict OpenCV iteration parity)")
    ap.add_argument("--phase-init-rotation", action="store_true",
                    help="also recover rotation/scale in the ECC warm "
                    "start (log-polar magnitude correlation)")
    ap.add_argument("--coarse-levels", type=int, default=0,
                    help="ECC coarse-to-fine octaves (0 = solve at full "
                    "resolution only, OpenCV semantics; N > 0 warm-starts "
                    "the solve from 2^N..2x downscaled octaves — same "
                    "converged warp, fewer full-resolution iterations)")
    ap.add_argument("--ecc-solver", choices=("forward", "lazy"),
                    default="forward",
                    help="ECC formulation: 'forward' = OpenCV's "
                    "forward-additive (bit-faithful); 'lazy' = forward "
                    "with the Hessian computed once per frame and "
                    "carried (same optimum, cheaper fused-kernel "
                    "iterations on a GPU)")
    ap.add_argument("--stacking", choices=("mean", "sigma_clip"),
                    default="mean",
                    help="stack estimator: 'mean' = reference semantics; "
                    "'sigma_clip' = per-pixel kappa-sigma outlier "
                    "rejection (rejects satellite trails / hot pixels / "
                    "single-frame glitches; re-warps the burst "
                    "1+sigma-iters times; whole-burst paths only)")
    ap.add_argument("--sigma-kappa", type=float, default=2.5)
    ap.add_argument("--sigma-iters", type=int, default=1)
    ap.add_argument("--output-scale", type=int, default=1,
                    choices=(1, 2, 3, 4),
                    help="super-resolution factor: stack onto an output "
                    "grid this many times finer than the input "
                    "(shift-and-add nearest-sample deposit; whole-burst "
                    "paths only)")
    ap.add_argument("--out-depth", type=int, choices=(8, 16), default=8,
                    help="output PNG bit depth: 16 preserves the extra "
                    "depth a stacked mean carries (~log2(N) bits past "
                    "the 8-bit inputs)")
    ap.add_argument("--preserve-depth", action="store_true",
                    help="decode 16-bit PNG/TIFF frames at full depth "
                    "and stack at 16-bit precision (alignment is "
                    "unchanged; pair with --out-depth 16)")
    ap.add_argument("--align-mask", "--ecc-mask", dest="align_mask",
                    metavar="PATH", default=None,
                    help="grayscale mask image (nonzero = valid): "
                    "excludes pixels from the alignment — ECC solves "
                    "ignore them on the reference frame (cv2 "
                    "findTransformECC's inputMask) and ORB detects no "
                    "keypoints there in any frame (cv2 "
                    "detectAndCompute's mask).  For moving subjects, "
                    "lens dirt, watermarks, dead sensor regions; "
                    "stacking still averages every pixel")
    ap.add_argument("--mesh", metavar="AUTO|N", default=None,
                    help="shard the burst over multiple devices via "
                    "the public mesh= argument: 'auto' uses every "
                    "visible device, an integer N builds a data-axis "
                    "mesh over the first N devices (the reference's "
                    "Rayon fan-out, src/lib.rs:746, as SPMD)")
    args = ap.parse_args()
    if args.stream > 0 and args.output_scale != 1:
        ap.error("--output-scale is not available with --stream (the "
                 "SR deposit needs whole-burst passes)")
    if args.output_scale != 1 and args.stacking != "mean":
        ap.error("--output-scale cannot be combined with "
                 "--stacking sigma_clip yet")

    import jax.numpy as jnp

    from libstacker_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    from libstacker_tpu import (
        EccMatchParameters,
        KeyPointMatchParameters,
        MotionType,
        constants,
        ecc_match_arrays,
        keypoint_match_arrays,
        sharpness_all,
    )
    from libstacker_tpu.ops import color
    from libstacker_tpu.utils import io
    from libstacker_tpu.utils.tracing import PhaseTimer

    mesh = None
    if args.mesh is not None:
        import jax

        from libstacker_tpu.parallel import make_mesh

        if args.mesh == "auto":
            mesh = "auto"  # the pipelines resolve it (no-op on 1 device)
        else:
            ndev = int(args.mesh)
            avail = len(jax.devices())
            if ndev > avail:
                print(f"--mesh {ndev} exceeds the {avail} visible "
                      "devices", file=sys.stderr)
                return 1
            mesh = make_mesh(jax.devices()[:ndev], data=ndev, spatial=1)

    timer = PhaseTimer()
    files = io.collect_image_files(args.image_dir)
    if len(files) < 2:
        print(f"need at least 2 frames in {args.image_dir}", file=sys.stderr)
        return 1

    with timer.phase("load+decode"):
        frames = io.load_frames(files, preserve_depth=args.preserve_depth)

    align_mask = None
    if args.align_mask:
        align_mask = np.asarray(io.imread_gray(args.align_mask))
        if align_mask.shape != frames.shape[1:3]:
            print(
                f"--align-mask shape {align_mask.shape} does not match "
                f"the frames {frames.shape[1:3]}",
                file=sys.stderr,
            )
            return 1

    with timer.phase("sharpness (all metrics, batched)"):
        grey = color.rgb_to_gray_u8(jnp.asarray(frames))
        metrics = {k: np.asarray(v) for k, v in sharpness_all(grey).items()}

    order = np.argsort(metrics["teng"], kind="stable")
    print("Files ordered by TENG (low quality first)")
    for i in order:
        print(
            f"{str(files[i]):>40s} LAPM:{metrics['lapm'][i]:>9.5f} "
            f"LAPV:{metrics['lapv'][i]:>10.5f} TENG:{metrics['teng'][i]:>9.5f} "
            f"GLVN:{metrics['glvn'][i]:>10.5f}"
        )

    # drop worst, reverse so sharpest is the reference frame
    keep = order[::-1] if args.keep_all else order[1:][::-1]
    frames = frames[keep]
    kept_files = [files[i] for i in keep]
    print(f"stacking {len(keep)} frames; reference = {kept_files[0]}")

    os.makedirs(args.out, exist_ok=True)
    kp_params = KeyPointMatchParameters(
        method=(constants.RANSAC if args.homography_method == "ransac"
                else constants.LMEDS),
        ransac_reproj_threshold=args.ransac_reproj_threshold,
        match_ratio=args.match_ratio,
        match_keep_ratio=args.match_keep_ratio,
        border_mode=args.border_mode,
        max_iters=args.max_iters,
        confidence=args.confidence,
        stacking=args.stacking,
        sigma_kappa=args.sigma_kappa,
        sigma_iters=args.sigma_iters,
        output_scale=args.output_scale,
    )
    ecc_params = EccMatchParameters(
        motion_type=MotionType[args.motion_type.capitalize()],
        max_count=args.max_count,
        epsilon=args.epsilon,
        gauss_filt_size=args.gauss_filt_size,
        phase_init=not args.no_phase_init,
        phase_init_rotation=args.phase_init_rotation,
        coarse_levels=args.coarse_levels,
        solver=args.ecc_solver,
        stacking=args.stacking,
        sigma_kappa=args.sigma_kappa,
        sigma_iters=args.sigma_iters,
        output_scale=args.output_scale,
    )

    scales = []
    if not args.no_full:
        scales.append(None)
    if not args.no_scaled:
        scales.append(args.scale_width)

    if args.stream > 0:
        from libstacker_tpu import ecc_match_stream, keypoint_match_stream

        def ckpt_path(kind, tag):
            # one resumable file per pipeline variant
            if args.checkpoint is None:
                return None
            return f"{args.checkpoint}.{kind}_{tag}.npz"

        for sw in scales:
            tag = "full" if sw is None else f"w{sw:.0f}"
            if args.method in ("keypoint", "all"):
                with timer.phase(f"keypoint_match_stream ({tag})"):
                    dropped, img = keypoint_match_stream(
                        kept_files, kp_params, sw, chunk_size=args.stream,
                        mask=align_mask,
                        preserve_depth=args.preserve_depth,
                        checkpoint_path=ckpt_path("keypoint", tag),
                        mesh=mesh,
                    )
                print(f"keypoint stream({tag}) dropped: {dropped}")
                save_png(os.path.join(args.out, f"keypoint_{tag}.png"), img,
                         args.out_depth)
            if args.method in ("ecc", "all"):
                with timer.phase(f"ecc_match_stream ({tag})"):
                    img = ecc_match_stream(
                        kept_files, ecc_params, sw, chunk_size=args.stream,
                        mask=align_mask,
                        preserve_depth=args.preserve_depth,
                        checkpoint_path=ckpt_path("ecc", tag),
                        mesh=mesh,
                    )
                save_png(os.path.join(args.out, f"ecc_{tag}.png"), img,
                         args.out_depth)
    else:
        sigma = args.stacking == "sigma_clip"

        def clip_note(stats):
            if sigma and stats.clipped_sample_frac is not None:
                return f" (sigma_clip rejected {stats.clipped_sample_frac:.2%} of samples)"
            return ""

        for sw in scales:
            tag = "full" if sw is None else f"w{sw:.0f}"
            if args.method in ("keypoint", "all"):
                with timer.phase(f"keypoint_match ({tag})"):
                    dropped, img, kstats = keypoint_match_arrays(
                        frames, kp_params, sw, return_stats=True,
                        mask=align_mask, mesh=mesh,
                    )
                print(f"keypoint_match({tag}) dropped frames: {dropped}"
                      + clip_note(kstats))
                save_png(os.path.join(args.out, f"keypoint_{tag}.png"), img,
                         args.out_depth)
            if args.method in ("ecc", "all"):
                with timer.phase(f"ecc_match ({tag})"):
                    img, estats = ecc_match_arrays(
                        frames, ecc_params, sw, return_stats=True,
                        mask=align_mask, mesh=mesh,
                    )
                if sigma:
                    print(f"ecc_match({tag}){clip_note(estats)}")
                save_png(os.path.join(args.out, f"ecc_{tag}.png"), img,
                         args.out_depth)

    print(timer.report())
    print(f"stacked images written to {args.out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

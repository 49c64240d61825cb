"""Secondary benchmark: keypoint_match (ORB+RANSAC) throughput at 4K,
GPU vs the OpenCV-CPU oracle pipeline (BASELINE.md config 1 scaled up).

Usage: python benchmarks/bench_keypoint.py [--frames 20] [--cpu]
Prints one JSON line per implementation run.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_textured_burst(n, h, w, seed=0):
    """Seeded burst with real corners (8x8 block texture) and small
    rotations/shifts (libstacker_tpu/utils/synth.py); host numpy u8."""
    from libstacker_tpu.utils import synth

    return np.asarray(
        synth.make_burst(n, h, w, seed=seed, content="blocks").frames
    )


def run_cpu(frames):
    """The reference pipeline recomputed with cv2 (src/lib.rs:146-353)."""
    import cv2

    n, h, w = frames.shape[:3]
    greys = [cv2.cvtColor(f[..., ::-1].copy(), cv2.COLOR_BGR2GRAY) for f in frames]
    f32s = [f.astype(np.float32) / 255.0 for f in frames]
    orb = cv2.ORB_create()
    t0 = time.perf_counter()
    kp0, des0 = orb.detectAndCompute(greys[0], None)
    acc = f32s[0].copy()
    kept = 1
    for i in range(1, n):
        kp, des = orb.detectAndCompute(greys[i], None)
        bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=False)
        knn = bf.knnMatch(des0, des, k=2)
        good = [m[0] for m in knn if len(m) == 2 and m[0].distance < 0.9 * m[1].distance]
        good.sort(key=lambda m: m.distance)
        good = good[: int(round(len(good) * 0.8))]
        if len(good) < 5:
            continue
        src = np.float32([kp[m.trainIdx].pt for m in good]).reshape(-1, 1, 2)
        dst = np.float32([kp0[m.queryIdx].pt for m in good]).reshape(-1, 1, 2)
        hmat, _ = cv2.findHomography(src, dst, cv2.RANSAC, 5.0)
        if hmat is None or abs(np.linalg.det(hmat)) < 1e-6:
            continue
        acc += cv2.warpPerspective(f32s[i], hmat, (w, h))
        kept += 1
    stacked = acc / kept
    dt = time.perf_counter() - t0
    return n / dt, kept


def run_device(frames):
    """Times the device pipeline with the result left on the device (one
    scalar fetched to synchronise)."""
    import jax
    import jax.numpy as jnp

    from libstacker_tpu.models import keypoint as kp

    fj = jnp.asarray(frames)
    key = jax.random.PRNGKey(0)

    def once():
        feats = kp.detect_features_chunked(fj)
        hs, oks, mc, ic = kp._match_and_estimate(
            feats, key, method=8, ransac_reproj_threshold=5.0,
            match_keep_ratio=0.8, match_ratio=0.9,
        )
        acc = kp._warp_and_accumulate(
            fj, hs, oks, border_mode=0, border_value=(0.0,) * 4,
        )
        kept = 1 + jnp.sum(oks.astype(jnp.int32))
        stacked = acc / kept.astype(jnp.float32)
        return float(stacked[0, 0, 0]), int(kept)

    once()
    t0 = time.perf_counter()
    _, kept = once()
    dt = time.perf_counter() - t0

    # attributable per-stage split (separate pass — the stage syncs
    # would perturb the headline)
    stage = {}
    t0s = time.perf_counter()
    feats = kp.detect_features_chunked(fj)
    jax.block_until_ready(feats.xy)
    _ = float(feats.xy[0, 0, 0])
    stage["detect_s"] = round(time.perf_counter() - t0s, 3)
    t0s = time.perf_counter()
    hs, oks, mc, ic = kp._match_and_estimate(
        feats, key, method=8, ransac_reproj_threshold=5.0,
        match_keep_ratio=0.8, match_ratio=0.9,
    )
    jax.block_until_ready(hs)
    stage["match_ransac_s"] = round(time.perf_counter() - t0s, 3)
    t0s = time.perf_counter()
    acc = kp._warp_and_accumulate(
        fj, hs, oks, border_mode=0, border_value=(0.0,) * 4,
    )
    _ = float(acc[0, 0, 0])
    stage["warp_stack_s"] = round(time.perf_counter() - t0s, 3)
    print(f"stages: {stage}", file=sys.stderr)
    return frames.shape[0] / dt, kept, stage


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--h", type=int, default=2160)
    ap.add_argument("--w", type=int, default=3840)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    frames = make_textured_burst(args.frames, args.h, args.w)
    stage = None
    if args.cpu:
        fps, kept = run_cpu(frames)
        impl = "opencv_cpu"
    else:
        fps, kept, stage = run_device(frames)
        impl = "libstacker_tpu"
    out = {
        "metric": f"keypoint_{args.frames}f_{args.h}x{args.w}_align_stack",
        "impl": impl,
        "value": round(fps, 3),
        "unit": "frames/sec",
        "frames_kept": int(kept),
    }
    if stage is not None:
        out["stages"] = stage
    print(json.dumps(out))


if __name__ == "__main__":
    main()

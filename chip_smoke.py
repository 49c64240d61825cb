"""Smoke test of the stacking pipelines on one NVIDIA GPU.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-gpus   # the data-parallel mesh on 4 cards

One process drives the public entry points on seeded 2160x3840 bursts
with known warps (libstacker_tpu/utils/synth.py):

1. device check: a GPU backend, and the card's name and power limit;
2. keypoint main path: ``keypoint_match_arrays`` on a 20-frame burst —
   kept frames, per-frame corner error against the true warps, stack
   PSNR against the base image, compiled memory and peak device memory;
3. ECC main path: ``ecc_match_arrays`` with a homography on a 100-frame
   burst — the same checks plus rho;
4. ECC kernel parity: the fused Triton iteration kernel's moments
   against the plain XLA fields (ops/ecc_triton.py) at 2160x3840 for
   translation, affine and homography, with and without an input mask;
5. timing of each phase once after a warm-up run (records, not
   claims).

With ``--four-gpus`` it runs only ``ecc_match_arrays`` and
``keypoint_match_arrays`` over a (data=4, spatial=1) mesh and compares
their stacks with the single-card stacks of the same burst.

Every number is printed beside its bound; a phase that fails raises and
the script exits non-zero.  The last line of standard output is the
JSON record ``{"ok": true, "device": {...}}``.  It refuses to run on
anything but a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

H, W = 2160, 3840
ECC_FRAMES = 100
KP_FRAMES = 20
MESH_FRAMES = 20
NOISE = 4.0  # per-frame Gaussian noise, 0..255 levels
MARGIN = 64  # PSNR interior: the warped borders hold zero fill

# ECC parameters of the main path (BASELINE.md's north-star config)
ECC_ITERS = 50
ECC_EPS = 1e-4

# bounds
PARITY_STATS_RTOL = 2e-5  # moments 0..5 (sums of non-negative terms)
PARITY_JAC_TOL = 1e-4  # other moments, over their Cauchy-Schwarz scale
ECC_CORNER_PX = 0.25
ECC_RHO_MEAN = 0.99
ECC_RHO_MIN = 0.98
ECC_PSNR_DB = 40.0
KP_CORNER_PX = 3.0  # the RANSAC reprojection threshold of the defaults
KP_PSNR_DB = 25.0
MESH_ECC_MAX_ABS = 2e-3  # [0,1] units, 4-card vs 1-card ECC stack
MESH_KP_PSNR_DB = 35.0  # 4-card vs 1-card keypoint stack


class SmokeFailure(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def check(name, value, ok, bound):
    log(f"  {name}: {value}  (bound: {bound})  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name} = {value} violates {bound}")


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why it
    could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi could not be read ({e})"
    return "; ".join(out.splitlines()) or "nvidia-smi printed nothing"


def gpu_backend_problem():
    """None when JAX runs on a GPU, else what it runs on."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        return f"chip_smoke needs a GPU; JAX's backend is {backend!r}"
    return None


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def print_memory(label, compiled) -> None:
    log(f"  memory_analysis[{label}]: {compiled.memory_analysis()}")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_kernel_parity(h: int, w: int, seed: int):
    """The fused kernel's moment vector against the XLA fields path."""
    import jax.numpy as jnp
    import numpy as np

    from libstacker_tpu.ops import ecc as ecc_ops, ecc_triton
    from libstacker_tpu.params import MotionType
    from libstacker_tpu.utils import synth

    log("phase: ECC kernel parity "
        f"({h}x{w}, 4 lanes, f32 sums, no matrix products)")
    burst = synth.make_burst(5, h, w, seed=seed, noise_sigma=NOISE)
    grey = jnp.asarray(burst.frames[..., 0], jnp.float32)
    image_f, gx, gy = ecc_ops._ecc_prepare_input_jit(grey[0], 5)
    rng = np.random.default_rng(seed)
    mask = np.ones((h, w), np.float32)
    mask[h // 3: h // 2, w // 4: w // 2] = 0.0  # an excluded region
    image_m, gx_m, gy_m, pre = ecc_ops._ecc_prepare_input_masked_jit(
        grey[0], jnp.asarray(mask), 5
    )
    templates = ecc_ops._ecc_prepare_templates_jit(
        grey[1:], 5, MotionType.Homography
    )[0]
    truth = burst.true_warps[1:].copy()
    worst = 0.0
    for motion in (MotionType.Translation, MotionType.Affine,
                   MotionType.Homography):
        m3 = truth.copy()
        m3[:, :2, 2] += rng.uniform(-0.5, 0.5, (4, 2))
        if motion == MotionType.Translation:
            m3[:, :2, :2] = np.eye(2)
        if motion != MotionType.Homography:
            m3[:, 2] = [0.0, 0.0, 1.0]
        for masked in (False, True):
            srcs = (
                jnp.stack([image_m, gx_m, gy_m, pre]) if masked
                else jnp.stack([image_f, gx, gy])
            )
            m3j = jnp.asarray(m3, jnp.float32)
            got = ecc_triton.ecc_iteration_moments(
                srcs, templates, m3j, jnp.ones((4,), bool),
                motion_type=motion,
                quant_affine=motion != MotionType.Homography,
            )
            want = ecc_triton.ecc_moments_reference(
                srcs, templates, m3j, motion_type=motion
            )
            stats_err, jac_err = ecc_triton.moments_error(
                np.asarray(got), np.asarray(want), motion
            )
            label = f"{motion.name}{' masked' if masked else ''}"
            check(f"{label} stats rel err", f"{stats_err:.3e}",
                  stats_err <= PARITY_STATS_RTOL,
                  f"<= {PARITY_STATS_RTOL}")
            check(f"{label} jacobian err / scale", f"{jac_err:.3e}",
                  jac_err <= PARITY_JAC_TOL, f"<= {PARITY_JAC_TOL}")
            worst = max(worst, jac_err)
    return worst


def phase_ecc(h: int, w: int, n: int, seed: int, timings: dict,
              memory: bool = True):
    """``ecc_match_arrays`` with a homography on the seeded burst."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libstacker_tpu import EccMatchParameters, MotionType
    from libstacker_tpu import ecc_match_arrays
    from libstacker_tpu.models import ecc as ecc_model
    from libstacker_tpu.ops import ecc as ecc_ops
    from libstacker_tpu.utils import synth

    log(f"phase: ECC main path ({n}x{h}x{w}, homography, "
        f"max_count={ECC_ITERS}, eps={ECC_EPS}, one coarse level)")
    burst = synth.make_burst(n, h, w, seed=seed, noise_sigma=NOISE)
    params = EccMatchParameters(
        MotionType.Homography, max_count=ECC_ITERS, epsilon=ECC_EPS,
        coarse_levels=1,
    )

    def run():
        out, stats = ecc_match_arrays(
            burst.frames, params, return_stats=True, device_output=True,
            on_failure="drop",
        )
        return jax.block_until_ready(out), stats

    t0 = time.perf_counter()
    out, stats = run()
    timings["ecc_main_first_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, stats = run()
    timings["ecc_main_s"] = time.perf_counter() - t0
    check("ECC kept frames", stats.frames_kept, stats.frames_kept == n,
          f"== {n}")
    rho = np.asarray(stats.ecc_rho)
    check("ECC rho mean", f"{rho.mean():.6f}", rho.mean() >= ECC_RHO_MEAN,
          f">= {ECC_RHO_MEAN}")
    check("ECC rho min", f"{rho.min():.6f}", rho.min() >= ECC_RHO_MIN,
          f">= {ECC_RHO_MIN}")

    # the solve of the main path, run alone for its warps
    grey = ecc_model._ecc_grey_jit(burst.frames)
    from libstacker_tpu.ops import phasecorr

    init = phasecorr.phase_init_warps(
        grey[1:], grey[0], motion_type=MotionType.Homography
    )
    t0 = time.perf_counter()
    res = ecc_ops.find_transform_ecc_batched(
        grey[1:], grey[0], MotionType.Homography, num_iters=ECC_ITERS,
        eps=ECC_EPS, gauss_filt_size=5, coarse_levels=1, warp_init=init,
    )
    jax.block_until_ready(res.warp_matrix)
    timings["ecc_solve_s"] = time.perf_counter() - t0
    err = synth.corner_error(
        np.asarray(res.warp_matrix), burst.true_warps[1:], h, w
    )
    check("ECC corner error max (px)", f"{err.max():.4f}",
          err.max() <= ECC_CORNER_PX, f"<= {ECC_CORNER_PX}")
    log(f"  ECC corner error mean (px): {err.mean():.4f}")
    img = np.asarray(out)
    check("ECC stack shape", img.shape, img.shape == (h, w, 3),
          f"== {(h, w, 3)}")
    check("ECC stack finite", bool(np.isfinite(img).all()),
          bool(np.isfinite(img).all()), "all finite")
    p_stack = synth.psnr(img, burst.base, MARGIN)
    p_one = synth.psnr(
        np.asarray(burst.frames[0], np.float64) / 255.0, burst.base, MARGIN
    )
    log(f"  frame-0 PSNR vs base (dB): {p_one:.2f}")
    check("ECC stack PSNR vs base (dB)", f"{p_stack:.2f}",
          p_stack >= ECC_PSNR_DB, f">= {ECC_PSNR_DB}")
    if memory:
        templates_f, carry = ecc_ops._ecc_prepare_templates_jit(
            grey[1:], 5, MotionType.Homography
        )
        image_f, gx, gy = ecc_ops._ecc_prepare_input_jit(grey[0], 5)
        print_memory("ECC solve program", ecc_ops._ecc_slab_jit.lower(
            templates_f, image_f, gx, gy, carry, MotionType.Homography,
            ECC_ITERS, ECC_EPS, None, kernel=ecc_ops._kernel_ok(h, w),
        ).compile())
        print_memory("ECC stacking program",
                     ecc_model._ecc_warp_accumulate_jit.lower(
                         burst.frames, res.warp_matrix, res.ok,
                         motion_type=MotionType.Homography,
                     ).compile())
        log("  peak device memory after keypoint and ECC (bytes): "
            f"{peak_bytes()}")
    return img


def phase_keypoint(h: int, w: int, n: int, seed: int, timings: dict,
                   memory: bool = True):
    """``keypoint_match_arrays`` on the seeded block-texture burst."""
    import jax
    import numpy as np

    from libstacker_tpu import KeyPointMatchParameters
    from libstacker_tpu import keypoint_match_arrays
    from libstacker_tpu.models import keypoint as kp
    from libstacker_tpu.utils import synth

    log(f"phase: keypoint main path ({n}x{h}x{w})")
    burst = synth.make_burst(n, h, w, seed=seed + 1, content="blocks",
                             noise_sigma=NOISE)
    params = KeyPointMatchParameters()

    def run():
        dropped, out = keypoint_match_arrays(
            burst.frames, params, seed=seed, device_output=True
        )
        return dropped, jax.block_until_ready(out)

    t0 = time.perf_counter()
    dropped, out = run()
    timings["kp_main_first_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dropped, out = run()
    timings["kp_main_s"] = time.perf_counter() - t0
    check("keypoint kept frames", n - dropped, dropped == 0, f"== {n}")
    # the same stages the entry point runs, for the homographies
    feats = kp.detect_features_chunked(burst.frames)
    hs, oks, _, _ = kp._match_and_estimate(
        feats, jax.random.PRNGKey(seed), method=params.method,
        ransac_reproj_threshold=params.ransac_reproj_threshold,
        match_keep_ratio=params.match_keep_ratio,
        match_ratio=params.match_ratio, max_iters=params.max_iters,
        confidence=params.confidence,
    )
    err = synth.corner_error(np.asarray(hs), burst.true_warps[1:], h, w)
    check("keypoint corner error max (px)", f"{err.max():.4f}",
          err.max() <= KP_CORNER_PX, f"<= {KP_CORNER_PX}")
    log(f"  keypoint corner error mean (px): {err.mean():.4f}")
    img = np.asarray(out)
    check("keypoint stack finite", bool(np.isfinite(img).all()),
          bool(np.isfinite(img).all()), "all finite")
    p_stack = synth.psnr(img, burst.base, MARGIN)
    check("keypoint stack PSNR vs base (dB)", f"{p_stack:.2f}",
          p_stack >= KP_PSNR_DB, f">= {KP_PSNR_DB}")
    if memory:
        print_memory("keypoint stacking program",
                     kp._warp_and_accumulate.lower(
                         burst.frames, hs, oks, border_mode=0,
                         border_value=(0.0,) * 4,
                     ).compile())
        log(f"  peak device memory after keypoint (bytes): {peak_bytes()}")
    return img


def phase_four_gpus(h: int, w: int, n: int, seed: int, timings: dict):
    """Both entry points over a (data=4, spatial=1) mesh against the
    single-card stacks of the same bursts."""
    import jax
    import numpy as np

    from libstacker_tpu import EccMatchParameters, MotionType
    from libstacker_tpu import KeyPointMatchParameters
    from libstacker_tpu import ecc_match_arrays, keypoint_match_arrays
    from libstacker_tpu.parallel import make_mesh
    from libstacker_tpu.utils import synth

    count = len(jax.devices())
    check("device count", count, count == 4, "== 4")
    mesh = make_mesh(jax.devices(), data=4, spatial=1)
    log(f"phase: 4-card mesh vs 1 card ({n}x{h}x{w} bursts)")
    ecc_burst = synth.make_burst(n, h, w, seed=seed, noise_sigma=NOISE)
    params = EccMatchParameters(
        MotionType.Homography, max_count=ECC_ITERS, epsilon=ECC_EPS,
        coarse_levels=1,
    )
    one = np.asarray(ecc_match_arrays(ecc_burst.frames, params))
    t0 = time.perf_counter()
    four = np.asarray(ecc_match_arrays(ecc_burst.frames, params, mesh=mesh))
    timings["ecc_mesh_first_s"] = time.perf_counter() - t0
    diff = np.abs(four - one)
    log(f"  ECC mean |4-card - 1-card|: {diff.mean():.3e}")
    check("ECC max |4-card - 1-card|", f"{diff.max():.3e}",
          diff.max() <= MESH_ECC_MAX_ABS, f"<= {MESH_ECC_MAX_ABS}")
    kp_burst = synth.make_burst(n, h, w, seed=seed + 1, content="blocks",
                                noise_sigma=NOISE)
    kparams = KeyPointMatchParameters()
    d1, one = keypoint_match_arrays(kp_burst.frames, kparams, seed=seed)
    t0 = time.perf_counter()
    d4, four = keypoint_match_arrays(kp_burst.frames, kparams, seed=seed,
                                     mesh=mesh)
    timings["kp_mesh_first_s"] = time.perf_counter() - t0
    check("keypoint dropped (1 card, 4 cards)", (d1, d4),
          d1 == 0 and d4 == 0, "(0, 0)")
    p = synth.psnr(np.asarray(four), np.asarray(one))
    check("keypoint PSNR 4-card vs 1-card (dB)", f"{p:.2f}",
          p >= MESH_KP_PSNR_DB, f">= {MESH_KP_PSNR_DB}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-card mesh path and its "
                         "comparison with one card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    problem = gpu_backend_problem()
    if problem:
        print(problem, file=sys.stderr)
        return 2
    import jax

    log(f"gpu: {gpu_name_and_power_limit()}")
    from libstacker_tpu.utils import enable_compilation_cache

    log(f"compile cache: {enable_compilation_cache() or 'off'}")
    dev = jax.devices()[0]
    timings: dict = {}
    if args.four_gpus:
        phase_four_gpus(H, W, MESH_FRAMES, args.seed, timings)
    else:
        # keypoint first, then ECC: each path's peak device memory is
        # read before the next one can raise it
        phase_keypoint(H, W, KP_FRAMES, args.seed, timings)
        phase_ecc(H, W, ECC_FRAMES, args.seed, timings)
        t0 = time.perf_counter()
        phase_kernel_parity(H, W, args.seed)
        timings["kernel_parity_s"] = time.perf_counter() - t0
    card = gpu_name_and_power_limit()
    for k, v in timings.items():
        log(f"time {k}: {v:.3f} s  ({card})")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark harness: batched ECC-homography align+stack throughput.

Prints ONE JSON line PER METRIC (stdout; progress on stderr), the
headline LAST so the driver's single-line parse records it — with every
secondary metric repeated inside its ``extra_metrics`` field, so
``BENCH_rNN.json`` machine-captures the keypoint / sigma-clip / masked
/ super-resolution numbers too (r3 VERDICT item 5), not just ECC:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "extra_metrics": {...}}

Config mirrors BASELINE.md's north-star: a 100-frame 4K (2160x3840)
burst aligned with MotionType::Homography ECC and averaged.  The
vs_baseline denominator is the measured OpenCV-CPU throughput on this
machine (benchmarks/cpu_baseline.json, produced by
benchmarks/measure_cpu_baseline.py — the reference publishes no numbers,
SURVEY.md §6).  Secondary benches run when the config is the full
100-frame default (quick A/B runs with BENCH_FRAMES<50 skip them);
BENCH_SECONDARY=0 disables, =1 forces.
"""

import json
import os
import sys
import time

import numpy as np

N_FRAMES = int(os.environ.get("BENCH_FRAMES", "100"))
H = int(os.environ.get("BENCH_H", "2160"))
W = int(os.environ.get("BENCH_W", "3840"))
CHUNK = int(os.environ.get("BENCH_CHUNK", "8"))
NUM_ITERS = 50
EPS = 1e-4
GAUSS = 5


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_burst(n, h, w, seed=0):
    """Seeded synthetic burst (libstacker_tpu/utils/synth.py): smooth
    random base, small random rotations and shifts; host numpy u8."""
    from libstacker_tpu.utils import synth

    return np.asarray(synth.make_burst(n, h, w, seed=seed).frames)


def gpu_card():
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi could not be read ({e})"


def main():
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        log(f"bench.py needs a GPU; JAX's backend is "
            f"{jax.default_backend()!r}")
        sys.exit(2)
    # persistent compilation cache: later runs skip the compile tail
    from libstacker_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    from libstacker_tpu.ops import color, ecc as ecc_ops, warp_batch
    from libstacker_tpu.params import MotionType

    card = gpu_card()
    log(f"devices: {jax.devices()}  card: {card}")
    log(f"building synthetic burst {N_FRAMES}x{H}x{W}...")
    frames = make_burst(N_FRAMES, H, W)

    @jax.jit
    def prep(frames_u8):
        grey = color.rgb_to_gray_u8(frames_u8).astype(jnp.float32)
        return grey

    log("uploading burst to HBM...")
    t0 = time.perf_counter()
    frames_j = jnp.asarray(frames)
    frames_j.block_until_ready()
    upload_s = time.perf_counter() - t0
    log(f"upload took {upload_s:.1f}s")

    from libstacker_tpu.ops import phasecorr

    def align_all(grey_all, stage=None):
        # ONE whole-burst solve (lane groups sized to device memory).
        # The solve warm-starts from a batched phase-correlation
        # translation estimate (ops/phasecorr.py) — same converged
        # warps, fewer iterations.
        t0 = time.perf_counter()
        init = phasecorr.phase_init_warps(
            grey_all[1:], grey_all[0], motion_type=MotionType.Homography,
            rotation=bool(os.environ.get("BENCH_PHASE_ROT")),
        )
        if stage is not None:
            init.block_until_ready()
            stage["phase_init_s"] = round(time.perf_counter() - t0, 3)
        return ecc_ops.find_transform_ecc_batched(
            grey_all[1:], grey_all[0],
            motion_type=MotionType.Homography,
            num_iters=NUM_ITERS, eps=EPS, gauss_filt_size=GAUSS,
            # production config: one coarse octave warm-starts the
            # full-res solve; the library default stays 0 for OpenCV
            # iteration parity
            coarse_levels=int(os.environ.get("BENCH_COARSE", "1")),
            warp_init=init,
        )

    @jax.jit
    def warp_accum(frames_chunk_u8, warps, oks, acc):
        # frame-by-frame warp+accumulate of the RAW u8 chunk; failed
        # lanes are identity-masked inside
        return acc + warp_batch.warp_accumulate_rgb(
            frames_chunk_u8, warps, oks, perspective=True,
        )

    def warp_stack(frames_j, res, stage=None):
        acc = color.u8_to_f32(frames_j[0]).astype(jnp.float32)
        for s in range(1, N_FRAMES, CHUNK):
            e = min(s + CHUNK, N_FRAMES)
            acc = warp_accum(
                frames_j[s:e], res.warp_matrix[s - 1 : e - 1],
                res.ok[s - 1 : e - 1], acc,
            )
        n_ok = 1 + jnp.sum(res.ok.astype(jnp.int32))
        stacked = acc / n_ok.astype(jnp.float32)
        return float(stacked[0, 0, 0]), stacked

    def run_once(frames_j, stage=None):
        t0 = time.perf_counter()
        grey_all = prep(frames_j)
        if stage is not None:
            grey_all.block_until_ready()
            stage["grey_s"] = round(time.perf_counter() - t0, 3)
            t0 = time.perf_counter()
        res = align_all(grey_all, stage=stage)
        if stage is not None:
            jax.block_until_ready(res.warp_matrix)
            stage["solve_s"] = round(time.perf_counter() - t0, 3)
            # solve-quality record for A/B legitimacy (knobs like
            # BENCH_COARSE/BENCH_PHASE_ROT must not trade rho for
            # speed); this pass is untimed, so the fetches are free
            stage["rho_mean"] = round(float(np.asarray(res.rho).mean()), 6)
            stage["iters_mean"] = round(
                float(np.asarray(res.num_iters).mean()), 2
            )
            stage["n_ok"] = int(np.asarray(res.ok).sum())
            t0 = time.perf_counter()
        out = warp_stack(frames_j, res)
        if stage is not None:
            stage["warp_stack_s"] = round(time.perf_counter() - t0, 3)
        return out

    sharded_ok = None
    if os.environ.get("BENCH_SHARDED"):
        # exercise the multi-device code path (shard_map solve + stacking
        # warp) on the card: a 1-device mesh runs the same sharded
        # program a multi-card mesh would
        log("sharded-path smoke (1-device mesh, 8 frames)...")
        from libstacker_tpu.ops import color
        from libstacker_tpu.parallel import mesh as pmesh

        n_s = 8
        sub = jnp.asarray(frames[:n_s])
        ref_grey = color.rgb_to_gray_u8(sub[0]).astype(jnp.float32)
        m1 = pmesh.make_mesh(jax.devices()[:1], data=1, spatial=1)
        t0 = time.perf_counter()
        with m1:
            stacked_sum, oks = pmesh.ecc_stack_step(
                sub, ref_grey, m1, motion_type=MotionType.Homography,
                num_iters=NUM_ITERS, eps=EPS, gauss_filt_size=GAUSS,
            )
        sh = np.asarray(stacked_sum[:2, :2, 0])
        dt = time.perf_counter() - t0
        ok_np = np.asarray(oks)
        # dense reference for the same frames through the host driver
        grey8 = prep(sub)
        res = ecc_ops.find_transform_ecc_batched(
            grey8[1:], grey8[0], motion_type=MotionType.Homography,
            num_iters=NUM_ITERS, eps=EPS, gauss_filt_size=GAUSS,
        )
        acc = warp_accum(
            sub[1:], res.warp_matrix, res.ok,
            color.u8_to_f32(sub[0]).astype(jnp.float32),
        )
        dense = np.asarray(acc[:2, :2, 0])
        rel = float(np.max(np.abs(sh - dense) / (np.abs(dense) + 1e-6)))
        sharded_ok = bool(ok_np.all()) and rel < 1e-3
        log(f"sharded smoke: ok={ok_np.all()} rel={rel:.2e} "
            f"({dt:.1f}s incl compile) -> "
            f"{'OK' if sharded_ok else 'MISMATCH'}")

    # Warmup decomposition: count the programs built during the warmup
    # run and split compile vs persistent-cache deserialisation vs
    # residual (first-dispatch device execution) via jax.monitoring.
    cstat = {"active": False, "n_programs": 0, "cache_hits": 0,
             "backend_compile_s": 0.0, "deserialise_s": 0.0,
             "trace_lower_s": 0.0}

    def _ev(name, **kw):
        if cstat["active"] and name == "/jax/compilation_cache/cache_hits":
            cstat["cache_hits"] += 1

    def _dur(name, dur, **kw):
        if not cstat["active"]:
            return
        if name == "/jax/core/compile/backend_compile_duration":
            cstat["n_programs"] += 1
            cstat["backend_compile_s"] += dur
        elif name == "/jax/compilation_cache/cache_retrieval_time_sec":
            cstat["deserialise_s"] += dur
        elif name in ("/jax/core/compile/jaxpr_trace_duration",
                      "/jax/core/compile/jaxpr_to_mlir_module_duration"):
            cstat["trace_lower_s"] += dur

    jax.monitoring.register_event_listener(_ev)
    jax.monitoring.register_event_duration_secs_listener(_dur)

    log("warmup/compile...")
    cstat["active"] = True
    t0 = time.perf_counter()
    run_once(frames_j)
    warmup_s = time.perf_counter() - t0
    cstat["active"] = False
    # backend_compile_duration INCLUDES the cache-retrieval time on a
    # hit, so fresh compilation is the difference; the residual is
    # first-dispatch device execution
    warmup_breakdown = {
        "n_programs": cstat["n_programs"],
        "cache_hits": cstat["cache_hits"],
        "compile_s": round(
            max(cstat["backend_compile_s"] - cstat["deserialise_s"], 0.0),
            2,
        ),
        "deserialise_s": round(cstat["deserialise_s"], 2),
        "trace_lower_s": round(cstat["trace_lower_s"], 2),
        "residual_dispatch_s": round(
            max(warmup_s - cstat["backend_compile_s"]
                - cstat["trace_lower_s"], 0.0), 2,
        ),
    }
    log(f"warmup took {warmup_s:.1f}s  breakdown={warmup_breakdown}")

    t0 = time.perf_counter()
    run_once(frames_j)
    dt = time.perf_counter() - t0
    fps = N_FRAMES / dt
    log(f"aligned+stacked {N_FRAMES} frames at {H}x{W} in {dt:.2f}s -> {fps:.2f} fps")

    # attributable per-stage split (separate pass: the stage syncs
    # would perturb the headline) — r2 VERDICT item 9
    stage = {}
    run_once(frames_j, stage=stage)
    stage["upload_s"] = round(upload_s, 2)
    log(f"stages: {stage}")

    bl = {}
    bl_path = os.path.join(os.path.dirname(__file__), "benchmarks", "cpu_baseline.json")
    if os.path.exists(bl_path):
        with open(bl_path) as f:
            bl = json.load(f)
    baseline_fps = bl.get(f"ecc_homography_{H}x{W}_fps")
    vs = (fps / baseline_fps) if baseline_fps else None

    # ---- secondary metrics (r3 VERDICT item 5): keypoint, sigma-clip,
    # masked and super-resolution, each emitted as its own JSON line and
    # repeated in the headline's extra_metrics so the driver's one-line
    # parse records them all
    sec_env = os.environ.get("BENCH_SECONDARY", "")
    run_secondary = sec_env == "1" or (sec_env != "0" and N_FRAMES >= 50)
    extra = {}
    if run_secondary:
        extra = run_secondaries(frames, bl)

    from libstacker_tpu.ops.ecc import _ecc_mode_default

    # end-to-end accounting: the headline value is steady-state COMPUTE
    # throughput with the burst resident in device memory; the
    # upload-inclusive number charges the one-off host-to-device
    # staging cost against the same single pass
    fps_with_upload = N_FRAMES / (dt + upload_s)
    out = {
        "metric": f"ecc_homography_{N_FRAMES}f_{H}x{W}_align_stack",
        "value": round(fps, 3),
        "unit": "frames/sec",
        "timing_basis": "compute_only_steady_state_burst_in_HBM",
        "fps_including_upload": round(fps_with_upload, 3),
        "vs_baseline": round(vs, 2) if vs else None,
        "warmup_s": round(warmup_s, 1),
        "warmup_breakdown": warmup_breakdown,
        "stages": stage,
        "ecc_mode": _ecc_mode_default(),
        "device": {
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
            "count": len(jax.devices()),
        },
        "card": card,
    }
    out["coarse_levels"] = int(os.environ.get("BENCH_COARSE", "1"))
    if os.environ.get("BENCH_PHASE_ROT"):
        out["phase_init_rotation"] = True
    if sharded_ok is not None:
        out["sharded_smoke_ok"] = sharded_ok
    if extra:
        out["extra_metrics"] = extra
    print(json.dumps(out), flush=True)


def run_secondaries(ecc_frames, bl):
    """Time the non-ECC headline paths on the real chip; one JSON line
    each, plus a compact summary dict for the headline's extra_metrics.
    Each metric times the SECOND run (first run pays compile, reported
    as warmup_s).  A wall-clock budget bounds the total so a driver
    bench run cannot stall on secondary compiles — the headline JSON
    line prints LAST, so a killed bench run would lose it."""
    budget_s = float(os.environ.get("BENCH_SECONDARY_BUDGET", "700"))
    t_start = time.perf_counter()
    summary = {}

    def emit(rec):
        print(json.dumps(rec), flush=True)
        summary[rec["metric"]] = {
            k: rec[k] for k in ("value", "unit", "warmup_s", "stages")
            if k in rec
        }

    def left():
        return budget_s - (time.perf_counter() - t_start)

    # keypoint 20f 4K (the r3 keypoint headline, machine-captured)
    try:
        if left() < 120:
            raise RuntimeError("secondary budget exhausted before start")
        sys.path.insert(0, os.path.join(os.path.dirname(__file__),
                                        "benchmarks"))
        import bench_keypoint as bk

        log("secondary: keypoint 20f burst...")
        kframes = bk.make_textured_burst(20, H, W)
        t0 = time.perf_counter()
        kfps, kept, kstage = bk.run_device(kframes)
        kwarm = time.perf_counter() - t0 - 20.0 / max(kfps, 1e-9)
        kbl = bl.get(f"keypoint_{H}x{W}_fps")
        emit({
            "metric": f"keypoint_20f_{H}x{W}_align_stack",
            "value": round(kfps, 3),
            "unit": "frames/sec",
            "vs_baseline": round(kfps / kbl, 2) if kbl else None,
            "warmup_s": round(max(kwarm, 0.0), 1),
            "frames_kept": int(kept),
            "stages": kstage,
        })
        # the reference's own recommended production config: detection
        # on a scale_down_width=800 grid ("2-4x speedup with minimal
        # accuracy loss", src/lib.rs:93,108), warp at full res
        if left() < 120:
            raise RuntimeError("secondary budget exhausted (scaled)")
        from libstacker_tpu.models.keypoint import keypoint_match_arrays
        from libstacker_tpu.params import KeyPointMatchParameters

        import jax.numpy as jnp

        kp_params = KeyPointMatchParameters()
        # stage once (headline methodology: steady-state burst on the
        # device; upload is reported separately by the headline)
        kfj = jnp.asarray(kframes)
        kfj.block_until_ready()

        def scaled_once():
            # device_output: result stays on the device, synced by one
            # scalar fetch
            d, img = keypoint_match_arrays(
                kfj, kp_params, scale_down_width=800.0,
                device_output=True,
            )
            return d, float(img[0, 0, 0])

        t0 = time.perf_counter()
        scaled_once()
        kwarm2 = time.perf_counter() - t0
        t0 = time.perf_counter()
        dropped, _ = scaled_once()
        dt2 = time.perf_counter() - t0
        emit({
            "metric": f"keypoint_scaled800_20f_{H}x{W}_align_stack",
            "value": round(20.0 / dt2, 3),
            "unit": "frames/sec",
            "warmup_s": round(kwarm2 - dt2, 1),
            "frames_kept": 20 - int(dropped),
        })
        del kframes
    except Exception as e:  # pragma: no cover - diagnostics only
        log(f"secondary keypoint FAILED: {e!r}")
        summary["keypoint_error"] = repr(e)

    from libstacker_tpu.models.ecc import ecc_match_arrays
    from libstacker_tpu.params import EccMatchParameters, MotionType

    def timed_pipeline(name, n_frames, **kwargs):
        """Warm + timed ecc_match_arrays run over the first n_frames of
        the headline burst (already decoded on host).  ``params``
        entries OVERRIDE the headline defaults (so secondaries can
        change the motion model / criteria, e.g. the BASELINE config-2
        Translation run)."""
        if left() < 60:
            log(f"secondary {name} skipped (budget)")
            summary[name + "_skipped"] = "budget"
            return
        import jax.numpy as jnp

        # stage once: the timed runs measure compute, not the
        # host-to-device copy (the headline reports upload_s separately)
        sub = jnp.asarray(ecc_frames[:n_frames])
        sub.block_until_ready()
        pkw = dict(
            motion_type=MotionType.Homography,
            max_count=NUM_ITERS, epsilon=EPS, gauss_filt_size=GAUSS,
            phase_init=True, coarse_levels=1,
        )
        pkw.update(kwargs.pop("params", {}))
        stats_stage = kwargs.pop("stats_stage", False)
        params = EccMatchParameters(**pkw)
        log(f"secondary: {name} ({n_frames}f)...")

        def once():
            out = ecc_match_arrays(
                sub, params, on_failure="drop", device_output=True,
                **kwargs,
            )
            return float(out[0, 0, 0])  # scalar sync, no image D2H

        try:
            t0 = time.perf_counter()
            once()
            warm_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            once()
            dt = time.perf_counter() - t0
        except Exception as e:  # pragma: no cover - diagnostics only
            log(f"secondary {name} FAILED: {e!r}")
            summary[name + "_error"] = repr(e)
            return
        rec = {
            "metric": f"{name}_{n_frames}f_{H}x{W}",
            "value": round(n_frames / dt, 3),
            "unit": "frames/sec",
            "warmup_s": round(warm_s - dt, 1),
        }
        if stats_stage:
            # untimed extra pass for the solve-quality stage record
            _, st = ecc_match_arrays(
                sub, params, on_failure="drop", device_output=True,
                return_stats=True, **kwargs,
            )
            rec["stages"] = {
                "iters_mean": round(
                    float(np.mean(st.ecc_iterations)), 2
                ) if st.ecc_iterations else None,
                "rho_mean": round(
                    float(np.mean(st.ecc_rho)), 6
                ) if st.ecc_rho else None,
                "n_kept": st.frames_kept,
            }
        emit(rec)

    timed_pipeline(
        "ecc_sigma_clip", 16,
        params=dict(stacking="sigma_clip", sigma_kappa=2.5, sigma_iters=1),
    )
    mask = np.full((H, W), 255, np.uint8)
    mask[: H // 4, : W // 4] = 0
    timed_pipeline("ecc_masked", 16, mask=mask)
    timed_pipeline("ecc_super_res_x2", 8, params=dict(output_scale=2))
    # BASELINE config 2 (r4 VERDICT item 4): the cheapest motion model
    # with OpenCV-style deep criteria (max_count=2500, eps=1e-4 — eps
    # terminates long before 2500, like the reference's TermCriteria).
    # Stage split: solve-quality stats from an untimed stats pass.
    timed_pipeline(
        "ecc_translation_mc2500", 16,
        params=dict(motion_type=MotionType.Translation, max_count=2500,
                    epsilon=1e-4),
        stats_stage=True,
    )
    sharpness_rank_stack(ecc_frames, bl, summary, emit, left)
    return summary


def sharpness_rank_stack(ecc_frames, bl, summary, emit, left, n_frames=16):
    """BASELINE config 4 (r4 VERDICT item 4): the reference example's
    end-to-end workflow — score all four sharpness metrics, sort
    ascending by Tenengrad, drop the worst frame, reverse so the
    sharpest is the reference, then ECC-align+stack
    (ref examples/main.rs:37-64).  Timed as one device-resident pass:
    scoring, ranking, reordering and stacking all run on the device."""
    name = "sharpness_rank_drop_stack"
    if left() < 90:
        log(f"secondary {name} skipped (budget)")
        summary[name + "_skipped"] = "budget"
        return
    import jax
    import jax.numpy as jnp

    from libstacker_tpu.models.ecc import ecc_match_arrays
    from libstacker_tpu.ops import color
    from libstacker_tpu.ops.sharpness import sharpness_all
    from libstacker_tpu.params import EccMatchParameters, MotionType

    sub = jnp.asarray(ecc_frames[:n_frames])
    sub.block_until_ready()
    params = EccMatchParameters(
        motion_type=MotionType.Homography, max_count=NUM_ITERS,
        epsilon=EPS, gauss_filt_size=GAUSS, phase_init=True,
        coarse_levels=1,
    )

    @jax.jit
    def rank(frames_u8):
        grey = color.rgb_to_gray_u8(frames_u8).astype(jnp.float32)
        scores = sharpness_all(grey)
        order = jnp.argsort(scores["teng"])  # ascending (main.rs:53)
        keep = order[1:][::-1]  # drop worst, sharpest becomes frame 0
        return jnp.take(frames_u8, keep, axis=0), scores

    def once(stage=None):
        t0 = time.perf_counter()
        burst, scores = rank(sub)
        if stage is not None:
            jax.block_until_ready(burst)
            stage["rank_s"] = round(time.perf_counter() - t0, 3)
            t0 = time.perf_counter()
        out = ecc_match_arrays(
            burst, params, on_failure="drop", device_output=True
        )
        r = float(out[0, 0, 0])  # scalar sync, no image D2H
        if stage is not None:
            stage["stack_s"] = round(time.perf_counter() - t0, 3)
        return r

    log(f"secondary: {name} ({n_frames}f)...")
    try:
        t0 = time.perf_counter()
        once()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        once()
        dt = time.perf_counter() - t0
        stage = {}
        once(stage=stage)  # untimed stage-split pass (syncs perturb)
    except Exception as e:  # pragma: no cover - diagnostics only
        log(f"secondary {name} FAILED: {e!r}")
        summary[name + "_error"] = repr(e)
        return
    emit({
        "metric": f"{name}_{n_frames}f_{H}x{W}",
        "value": round(n_frames / dt, 3),
        "unit": "frames/sec",
        "warmup_s": round(warm_s - dt, 1),
        "stages": stage,
    })


if __name__ == "__main__":
    main()

"""Profile the two main paths on one GPU and summarise where the device
time goes.

    python benchmarks/trace_main_paths.py [--out chiprun_out/trace]

Runs ``ecc_match_arrays`` (100x2160x3840, homography, max_count=50,
eps=1e-4, one coarse level) and ``keypoint_match_arrays`` (20x2160x3840)
on the seeded bursts of libstacker_tpu/utils/synth.py — the workloads
of chip_smoke.py — once to compile, then once each under
``jax.profiler.trace``.  For each traced window it prints the wall
time, the device's busy share (union of kernel intervals on the GPU
planes' stream lines over the window) and the kernels that take the
most device time.  The raw trace stays under ``--out``.
"""

import argparse
import glob
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def summarise(trace_dir, window_ns, top=12):
    from jax.profiler import ProfileData

    paths = glob.glob(
        os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")
    )
    if not paths:
        return "no trace file found"
    prof = ProfileData.from_file(sorted(paths)[-1])
    lines_out = []
    intervals = []
    per_kernel = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines_out.append(
                f"  {plane.name} / {line.name}: {len(events)} events, "
                f"{sum(e.duration_ns for e in events) / 1e6:.3f} ms"
            )
            if "stream" not in line.name.lower():
                continue
            for e in events:
                intervals.append((e.start_ns, e.end_ns))
                per_kernel[e.name] = per_kernel.get(e.name, 0) + e.duration_ns
    busy = 0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    out = lines_out + [
        f"  device busy (stream union): {busy / 1e6:.3f} ms of a "
        f"{window_ns / 1e6:.3f} ms window -> idle share "
        f"{1 - busy / max(window_ns, 1):.3f}",
        "  top kernels by device time:",
    ]
    for name, ns in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]:
        out.append(f"    {ns / 1e6:9.3f} ms  {name[:110]}")
    return "\n".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/trace")
    args = ap.parse_args()

    import jax

    from libstacker_tpu import (
        EccMatchParameters, KeyPointMatchParameters, MotionType,
        ecc_match_arrays, keypoint_match_arrays,
    )
    from libstacker_tpu.utils import enable_compilation_cache, synth

    if jax.default_backend() != "gpu":
        sys.exit(f"needs a GPU, backend is {jax.default_backend()!r}")
    enable_compilation_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {card}")
    ecc_burst = synth.make_burst(100, 2160, 3840, seed=0, noise_sigma=4.0)
    kp_burst = synth.make_burst(20, 2160, 3840, seed=1, content="blocks",
                                noise_sigma=4.0)
    params = EccMatchParameters(
        MotionType.Homography, max_count=50, epsilon=1e-4, coarse_levels=1,
    )
    runs = {
        "ecc_main": lambda: ecc_match_arrays(
            ecc_burst.frames, params, device_output=True
        ),
        "keypoint_main": lambda: keypoint_match_arrays(
            kp_burst.frames, KeyPointMatchParameters(), device_output=True
        )[1],
    }
    for name, fn in runs.items():
        jax.block_until_ready(fn())  # compile
        d = os.path.join(args.out, name)
        t0 = time.perf_counter_ns()
        with jax.profiler.trace(d):
            jax.block_until_ready(fn())
        window = time.perf_counter_ns() - t0
        print(f"{name}: traced wall {window / 1e6:.3f} ms ({card})")
        print(summarise(d, window))


if __name__ == "__main__":
    main()

"""Time the ECC solve stage with the fused Triton kernel and with the
plain XLA path, each as one program per solve (the default) and with a
given number of Gauss-Newton iterations per program, in one process on
one GPU.

    python benchmarks/ecc_solve_ab.py [--frames 100] [--repeats 2]
        [--configs kernel,kernel:7,xla,xla:4]

The solve is ``find_transform_ecc_batched`` over frames 1..N-1 of the
seeded 2160x3840 burst (libstacker_tpu/utils/synth.py): homography,
max_count=50, eps=1e-4, one coarse level, phase-correlation warm start
— the stage ``ecc_match_arrays`` runs.  The XLA path is selected by
replacing ``ops.ecc._kernel_ok`` in this process only.  Each
configuration runs once to compile, then ``--repeats`` timed runs; one
JSON line per configuration.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--h", type=int, default=2160)
    ap.add_argument("--w", type=int, default=3840)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--configs", default="kernel,kernel:7,xla,xla:4",
                    help="comma list of kernel|xla, each optionally "
                         "followed by :N iterations per program")
    args = ap.parse_args()

    import jax
    import numpy as np

    from libstacker_tpu.models import ecc as ecc_model
    from libstacker_tpu.ops import ecc as ecc_ops, phasecorr
    from libstacker_tpu.params import MotionType
    from libstacker_tpu.utils import enable_compilation_cache, synth

    if jax.default_backend() != "gpu":
        sys.exit(f"needs a GPU, backend is {jax.default_backend()!r}")
    enable_compilation_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    burst = synth.make_burst(args.frames, args.h, args.w, noise_sigma=4.0)
    grey = ecc_model._ecc_grey_jit(burst.frames)
    init = phasecorr.phase_init_warps(
        grey[1:], grey[0], motion_type=MotionType.Homography
    )
    kernel_ok = ecc_ops._kernel_ok
    iters = 50

    def solve(slab):
        res = ecc_ops.find_transform_ecc_batched(
            grey[1:], grey[0], MotionType.Homography, num_iters=iters,
            eps=1e-4, gauss_filt_size=5, coarse_levels=1, warp_init=init,
            slab_iters=slab,
        )
        jax.block_until_ready(res.warp_matrix)
        return res

    for name in args.configs.split(","):
        path, _, slab = name.partition(":")
        if path not in ("kernel", "xla"):
            sys.exit(f"unknown config {name!r}")
        ecc_ops._kernel_ok = (
            kernel_ok if path == "kernel" else (lambda h, w: False)
        )
        slab = int(slab) if slab else None
        rec = {"config": name, "frames": args.frames,
               "hw": [args.h, args.w], "card": card}
        try:
            t0 = time.perf_counter()
            solve(slab)
            rec["first_s"] = time.perf_counter() - t0
            times = []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                res = solve(slab)
                times.append(time.perf_counter() - t0)
        except jax.errors.JaxRuntimeError as e:
            rec["error"] = str(e)[:300]
            print(json.dumps(rec), flush=True)
            continue
        err = synth.corner_error(
            np.asarray(res.warp_matrix), burst.true_warps[1:], args.h,
            args.w,
        )
        rec.update(
            solve_s=times,
            n_ok=int(np.asarray(res.ok).sum()),
            rho_mean=float(np.asarray(res.rho).mean()),
            iters_mean=float(np.asarray(res.num_iters).mean()),
            corner_err_max=float(err.max()),
        )
        print(json.dumps(rec), flush=True)
    ecc_ops._kernel_ok = kernel_ok


if __name__ == "__main__":
    main()

"""chip_smoke.py on the CPU: it refuses to run, prints no result, and
its phases pass their own checks on a small burst."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_refuses_a_cpu_backend(capsys):
    assert chip_smoke.main([]) != 0
    out, err = capsys.readouterr()
    assert "needs a GPU" in err
    assert '"ok"' not in out


def test_script_alone_exits_nonzero_without_result(tmp_path):
    """Run as the driver runs it, from a directory holding only the
    script: non-zero exit, no JSON line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_gpu_name_when_nvidia_smi_is_missing(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(chip_smoke.subprocess, "run", missing)
    assert chip_smoke.gpu_name_and_power_limit().startswith(
        "nvidia-smi could not be read"
    )


def test_check_raises_on_a_violated_bound(capsys):
    chip_smoke.check("x", 1, True, "== 1")
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check("x", 2, False, "== 1")
    assert "FAIL" in capsys.readouterr().out


def test_phases_pass_on_a_small_cpu_burst(ecc_kernel_interpret):
    """The smoke's ECC, keypoint and kernel-parity phases on a small
    burst (kernel in the Pallas interpreter): every check holds."""
    timings = {}
    with ecc_kernel_interpret.off():
        chip_smoke.phase_ecc(216, 384, 5, 0, timings, memory=False)
    chip_smoke.phase_keypoint(216, 384, 4, 0, timings, memory=False)
    chip_smoke.phase_kernel_parity(96, 160, 0)
    assert timings["ecc_main_s"] > 0 and timings["kp_main_s"] > 0

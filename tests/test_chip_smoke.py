"""chip_smoke.py: its device gate, and every phase at a tiny size on the
CPU (the chip run repeats them at detector scale on the GPU)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code not in (0, None)


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _prints_result(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "ok" in json.loads(lines[-1])
    except ValueError:
        return False


def test_main_on_cpu_exits_without_result():
    r = _run_smoke(REPO, {"PYTHONPATH": REPO})
    assert r.returncode != 0
    assert not _prints_result(r.stdout)
    assert "needs a GPU" in r.stderr


def test_alone_without_the_repo_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), {"PYTHONPATH": ""})
    assert r.returncode != 0
    assert not _prints_result(r.stdout)


def test_phase_lookups_tiny():
    found = chip_smoke.phase_lookups(n_lanes=2048)
    assert all(found[k] for k in found if k != "single_pass_dot_exact")


def test_phase_oracle_tiny():
    zs = chip_smoke.phase_oracle(n_steps=512, photons_per_step=8)
    assert "total_hits" in zs


def test_phase_served_tiny():
    found = chip_smoke.phase_served(n_events=1, energy_gev=50.0,
                                    n_slots=4096)
    assert found["rec_count_sum"] == found["n_hits"]
    assert found["mcpes"] > 0


def test_phase_icefit_tiny():
    found = chip_smoke.phase_icefit(n_photons=2048, max_iterations=16)
    assert found["grad_norm_log_sb"] > 0.0


def test_phase_four_tiny():
    """The four-device path on four of the virtual CPU devices."""
    out = chip_smoke.phase_four(n_dev=4, per_dev_slots=256,
                                photons_per_slot=2, fit_photons=2048,
                                fit_iterations=16)
    assert set(out["fit"]) == {"4 cards", "1 card"}


@pytest.mark.gpu
def test_lookups_bitwise_on_card(gpu):
    """Phase 1 at its full width on the card (TF32 may be on there)."""
    chip_smoke.phase_lookups()

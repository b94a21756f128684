"""``chip_smoke.py`` on the CPU: each phase at reduced size against its
float64 reference, and the refusal to run without a GPU.

The phases run here in float64, so their comparisons pass with room to
spare; what these cases pin is that every phase drives its API path and
its reference end to end.  The full-width float32 run is the script
itself, on the GPU.
"""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _hm_case():
    _, case = chip_smoke.phase_history_matching(n_outputs=2, n_coords=8192,
                                                n_check=256)
    return case


PHASES = {
    "fit": lambda: chip_smoke.phase_fit(n_outputs=3, n_tries=4, maxiter=20),
    "predict": lambda: chip_smoke.phase_predict(n_query=40_000, n_check=512),
    "history_matching": lambda: chip_smoke.phase_history_matching(
        n_outputs=2, n_coords=8192, n_check=512),
    "large_n": lambda: chip_smoke.phase_large_n(n=1024),
    "nan_lanes": lambda: chip_smoke.phase_nan_lanes(batch=24, n=60, bad=5,
                                                    n_large=1024),
    "surface": lambda: chip_smoke.phase_surface(
        _hm_case(), n_chains=4, n_iters=80, vi_steps=50, mice_cand=300,
        mice_steps=1, smc_particles=256),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_phase_matches_f64_reference(phase, monkeypatch):
    from mogp_tpu.uq import experimental_design, history_matching

    # reach the fused sweep and the device MaxiMin scorer at CPU size
    monkeypatch.setattr(history_matching, "_DEVICE_SWEEP_MIN_COORDS", 4096)
    monkeypatch.setattr(experimental_design, "_use_device_scorer",
                        lambda: True)
    checks, _ = PHASES[phase]()
    assert checks
    bad = [str(c) for c in checks if not c.ok]
    assert not bad, bad


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out


def test_script_alone_fails(tmp_path):
    """In a directory holding only the script it exits non-zero and prints
    no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_check_formats_and_fails_on_nan():
    c = chip_smoke.Check("x", float("nan"), 1.0, "why")
    assert not c.ok and "FAILED" in str(c)
    assert chip_smoke.Check("y", 0.5, 1.0, "why").ok

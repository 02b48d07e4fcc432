"""Smoke-run the examples so they stay green (CPU, four virtual devices)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "script",
    [
        "bits_back.py",
        "multichip_sharded.py",
        "reference_exact_and_seek.py",
        "default_preset.py",
        "compact_framing.py",
    ],
)
def test_example_runs(script):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script)],
        capture_output=True, text=True, timeout=900, env=env,
    )
    assert r.returncode == 0, r.stdout + r.stderr

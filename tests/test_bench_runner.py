"""The bench runner: one child per bench, a failure or a hang is reported
and makes the suite exit non-zero; nothing is retried.

These tests drive the real parent/child subprocess machinery through the
hidden host-only `_hang` and `_fail` benches (no jax imported), so they are
fast and device-free. The peak table refuses device kinds it does not know.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")
sys.path.insert(0, REPO)


def test_hung_child_is_killed_and_retried():
    """A hung child is killed at FDTD2D_BENCH_TIMEOUT, once, and the suite
    fails instead of retrying it."""
    env = {**os.environ, "FDTD2D_BENCH_TIMEOUT": "2"}
    proc = subprocess.run(
        [sys.executable, BENCH, "--only", "_hang"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.stderr.count("timed out") == 1, proc.stderr
    assert "failed: ['_hang']" in proc.stderr, proc.stderr
    assert proc.returncode == 1, proc.stderr
    assert proc.stdout.strip() == "", proc.stdout


def test_unknown_bench_rejected():
    proc = subprocess.run(
        [sys.executable, BENCH, "--only", "nosuchbench"],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2
    assert "unknown bench" in proc.stderr


def test_suite_deadline_skips_remaining():
    env = {**os.environ, "FDTD2D_BENCH_TIMEOUT": "30",
           "FDTD2D_BENCH_SUITE_TIMEOUT": "2"}
    proc = subprocess.run(
        [sys.executable, BENCH, "--only", "_hang,_fail"],
        env=env, capture_output=True, text=True, timeout=120)
    # `_hang` is capped by the 2 s suite deadline, `_fail` is not run
    assert proc.stderr.count("timed out") == 1, proc.stderr
    assert "deadline exceeded" in proc.stderr, proc.stderr
    assert "deliberate failure" not in proc.stderr, proc.stderr
    assert proc.returncode == 1, proc.stderr


def test_failing_child_exits_nonzero():
    proc = subprocess.run(
        [sys.executable, BENCH, "--only", "_fail"],
        capture_output=True, text=True, timeout=120)
    assert "[bench _fail] failed" in proc.stderr, proc.stderr
    assert "deliberate failure" in proc.stderr, proc.stderr
    assert proc.returncode == 1
    assert proc.stdout.strip() == ""


def test_peak_table_raises_on_unknown_device_kind():
    import bench

    assert bench.peak_for("NVIDIA H100 80GB HBM3")["bf16_tflops"] == 989.0
    with pytest.raises(ValueError, match="no published peak"):
        bench.peak_for("cpu")

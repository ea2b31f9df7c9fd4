"""The port's quantize-then-serve CLI (``python -m repro_torch.launch.serve``)
on the host: calibrate + AllocateBits + RaBitQ-H on tiny llama2, then the
paged engine, fused and unfused.  Greedy decode is deterministic and the two
paths compute the same function, so the ``sample:`` lines must be
byte-identical.  Without ``--device cpu`` the CLI runs on the card, so on a
host with no card it must refuse with ``resolve_device``'s message."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
CMD = [sys.executable, "-m", "repro_torch.launch.serve", "--tiny",
       "--avg-bits", "3.3", "--requests", "2", "--gen", "8"]

pytestmark = pytest.mark.tier2  # runs the whole pipeline twice


def _run(*extra, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(env_extra or {})
    return subprocess.run([*CMD, *extra], cwd=ROOT, env=env,
                          capture_output=True, timeout=600)


def _sample(res) -> bytes:
    assert res.returncode == 0, res.stderr.decode(errors="replace")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith(b"sample:")]
    assert len(lines) == 1
    return lines[0]


def test_fused_and_unfused_samples_identical():
    fused = _run("--device", "cpu")
    unfused = _run("--device", "cpu", "--unfused")
    assert _sample(fused) == _sample(unfused)
    out = fused.stdout.decode(errors="replace")
    assert "calibrating + quantizing (3.3 avg bits)" in out
    assert "quantized 24 layers, achieved" in out and "allocate_s=" in out
    assert "fused decode path" in out and "prefix_cache=off" in out
    assert "unfused decode path" in unfused.stdout.decode(errors="replace")


def test_refuses_to_run_on_the_host_without_a_card():
    # CUDA_VISIBLE_DEVICES="" hides any card, so the default device is absent
    res = _run(env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert b"device='cpu'" in res.stderr
    assert b"sample:" not in res.stdout and b"calibrating" not in res.stdout

"""The port's quantize-then-serve CLI (``python -m repro_torch.launch.serve``)
on the host: calibrate + AllocateBits + RaBitQ-H on tiny llama2 and on tiny
mixtral (grouped MoE experts, window 16, so the 40-token requests wrap the
ring), then the paged engine, fused and unfused, with the prefix cache on
and off, and speculating from a 2.2-bit draft.  Greedy decode is
deterministic and the paths compute the same function (greedy speculation
emits only the target's argmax tokens), so the ``sample:`` lines must be
byte-identical.  ``--kv-dtype bf16`` serves from bf16 arenas.  Without
``--device cpu`` the CLI runs on the card, so on a host with no card it
must refuse with ``resolve_device``'s message."""
import functools
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


@functools.lru_cache(maxsize=None)
def _run_once(*extra):
    """``_run(*extra)``, run once per module: two tests share the plain
    host run."""
    return _run(*extra)


def _sample(res) -> bytes:
    assert res.returncode == 0, res.stderr.decode(errors="replace")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith(b"sample:")]
    assert len(lines) == 1
    return lines[0]


def test_fused_and_unfused_samples_identical():
    fused = _run_once("--device", "cpu")
    unfused = _run("--device", "cpu", "--unfused")
    assert _sample(fused) == _sample(unfused)
    out = fused.stdout.decode(errors="replace")
    assert "calibrating + quantizing (3.3 avg bits)" in out
    assert "quantized 24 layers, achieved" in out and "allocate_s=" in out
    # 2 identical prompts admitted together: the cache is on, nothing hits
    assert "fused decode path" in out and "prefix_cache=on" in out
    assert "prefix_hit_rate=0.00" in out
    assert "unfused decode path" in unfused.stdout.decode(errors="replace")


def test_prefix_cache_on_and_off_samples_identical():
    """8 identical prompts over 4 slots: the second admission wave finds
    the first wave's prompt blocks cached (31 of each 32-token prompt, the
    last block's 15 tokens by a copy-on-write clone)."""
    on = _run("--device", "cpu", "--requests", "8")
    off = _run("--device", "cpu", "--requests", "8", "--no-prefix-cache")
    assert _sample(on) == _sample(off)
    out = on.stdout.decode(errors="replace")
    assert "prefix_hit_rate=0.48, prefill_tokens_saved=124" in out
    assert "prefix_cache=off" in off.stdout.decode(errors="replace")


def test_mixtral_fused_and_unfused_samples_identical():
    arch = ("--arch", "mixtral-8x7b", "--device", "cpu")
    fused = _run(*arch)
    unfused = _run(*arch, "--unfused")
    assert _sample(fused) == _sample(unfused)
    out = fused.stdout.decode(errors="replace")
    # 2 layers x (wq, wk, wv, wo + the grouped experts' wi, wo)
    assert "quantized 12 layers, achieved" in out
    assert "served 2 requests x 8 tokens" in out


def test_speculation_sample_identical_to_spec_off():
    off = _run_once("--device", "cpu")
    spec = _run("--device", "cpu", "--speculate", "2", "--draft-bits", "2.2")
    assert _sample(spec) == _sample(off)
    out = spec.stdout.decode(errors="replace")
    assert "calibrating + quantizing (3.3 avg bits, 2.2-bit draft)" in out
    assert " target / " in out and " draft bits in " in out
    assert "speculate=2, acceptance_rate=" in out and "spec_rounds=" in out


def test_bf16_kv_arenas_serve():
    res = _run("--device", "cpu", "--kv-dtype", "bf16")
    _sample(res)
    assert "kv=bf16" in res.stdout.decode(errors="replace")


def test_refuses_to_run_on_the_host_without_a_card():
    # CUDA_VISIBLE_DEVICES="" hides any card, so the default device is absent
    res = _run(env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert b"device='cpu'" in res.stderr
    assert b"sample:" not in res.stdout and b"calibrating" not in res.stdout

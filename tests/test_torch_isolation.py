"""The port stands alone: every module of ``repro_torch`` and ``chip_smoke.py``
imports with JAX and the reference package made unimportable, and the
entry points refuse to run quietly on the host when no card is present."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = textwrap.dedent("""
    import importlib, importlib.abc, importlib.util, pkgutil, sys

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            # "repro" and "repro.*" only: "repro_torch" must stay importable
            if name == "repro" or name.startswith("repro."):
                raise ImportError(f"the port imported {name}")
            return None

    sys.modules["jax"] = None
    sys.meta_path.insert(0, Refuse())
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.launch.serve" in names
    for name in names:
        importlib.import_module(name)       # the CLI's main() must not run
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  sys.argv[1])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)           # defines main(), does not run it
    assert callable(mod.main)
    assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                   for m in sys.modules if sys.modules[m] is not None)
    print(len(names))
""")


def test_port_imports_without_jax_or_reference():
    res = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "chip_smoke.py")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert not res.stdout.startswith("calibrating")
    assert int(res.stdout.split()[-1]) >= 46    # every module was imported


def test_entry_points_refuse_host_without_card(monkeypatch):
    from repro_torch.configs import get_tiny
    from repro_torch.core.qlinear import draw_signs, quantize_linear
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import PagedServer

    cfg = get_tiny("llama2-7b")
    params = init_params(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedServer(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    s1, s2 = draw_signs(128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quantize_linear(torch.randn(128, 8), 4, s1, s2)

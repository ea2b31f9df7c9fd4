"""The port's roofline, dry-run, report and reanalysis
(``repro_torch/launch/{roofline,dryrun,report,reanalyze}.py``) against
the JAX reference (``repro/launch/roofline.py``) and on the host.

``count_params`` and ``model_flops`` equal the reference's exactly for
every registry config (the port builds the params on fake tensors, the
reference by ``jax.eval_shape``).  ``analyze`` equals the reference's on
the same record when the hardware constants are the reference's.
``run_cell`` on tiny configs (``device="cpu"``, a (2, 2) mesh) writes
the reference's record keys for the serve shapes and skips where the
reference skips (long_500k on full-attention archs) and where the port
does not run (train_4k: model-parallel training is not ported);
``memory.argument`` equals the bytes of the rank's tensors; the CLI
refuses the variants that need ``runtime/actsharding.py``; ``report``
renders and ``reanalyze`` reproduces a record from its op trace.
"""
import dataclasses
import functools
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          get_tiny)
from repro_torch.launch import dryrun, reanalyze, report  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch.mesh import ProductionMesh  # noqa: E402

MESH = ProductionMesh(("data", "model"), (2, 2))
# the reference's count_params traces the full-width init on every call
_ref_counts = functools.lru_cache(maxsize=None)(jroof.count_params)


@pytest.fixture(autouse=True)
def _cached_reference_counts(monkeypatch):
    monkeypatch.setattr(jroof, "count_params", _ref_counts)


OK_KEYS = {"status", "arch", "shape", "kind", "mesh", "chips", "seq_len",
           "global_batch", "quant", "flops", "hlo_bytes", "coll_bytes",
           "coll_by_kind", "memory", "unknown_trip_whiles", "tp", "dp",
           "argument_specs"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_and_model_flops_equal_the_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), get_config(arch)
    assert troof.count_params(tcfg) == _ref_counts(jcfg)
    for kind, s, b in (("train", 4096, 256), ("prefill", 32768, 32),
                       ("decode", 32768, 128)):
        assert troof.model_flops(tcfg, kind, s, b) == \
            jroof.model_flops(jcfg, kind, s, b)


@pytest.mark.parametrize("arch", ("llama2-7b", "mixtral-8x7b",
                                  "deepseek-v2-236b", "rwkv6-3b"))
def test_analyze_equals_the_reference_with_its_constants(arch, monkeypatch):
    monkeypatch.setattr(troof, "PEAK_FLOPS", jroof.PEAK_FLOPS)
    monkeypatch.setattr(troof, "HBM_BW", jroof.HBM_BW)
    monkeypatch.setattr(troof, "LINK_BW", {"model": jroof.ICI_BW})
    for rec in ({"chips": 256, "flops": 3.1e12, "hlo_bytes": 4.2e10,
                 "coll_bytes": 7.7e8, "kind": "decode", "seq_len": 32768,
                 "global_batch": 128, "quant": 4},
                {"chips": 512, "flops": 9.9e15, "hlo_bytes": 1.1e12,
                 "coll_bytes": 3.0e9, "kind": "prefill", "seq_len": 32768,
                 "global_batch": 32, "quant": None}):
        got = troof.analyze(rec, get_config(arch)).as_dict()
        want = jroof.analyze(rec, jreg.get_config(arch)).as_dict()
        assert got == want


def _art(tmp_path):
    return str(tmp_path / "art")


def test_run_cell_records_the_reference_keys(tmp_path):
    art = _art(tmp_path)
    seen = {}
    for arch in ("llama2-7b", "mixtral-8x7b", "rwkv6-3b"):
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            for quant in (None, 4):
                rec = dryrun.run_cell(arch, shape, quant=quant, mesh=MESH,
                                      tiny=True, device="cpu", art_dir=art)
                seen[arch, shape, quant] = rec
                tag = f"{arch}__{shape}__2x2" + (f"__q{quant}" if quant
                                                 else "")
                with open(os.path.join(art, tag + ".json")) as f:
                    assert json.load(f) == rec
                cfg = get_tiny(arch)
                if shape == "train_4k":
                    assert rec["status"] == "skip"
                    assert "ROADMAP Queue 1 item 10" in rec["reason"]
                elif shape == "long_500k" and not cfg.subquadratic:
                    assert rec["status"] == "skip"
                    assert rec["reason"].startswith(
                        "SKIP: pure full-attention")
                else:
                    assert rec["status"] == "ok", rec.get("error")
                    assert OK_KEYS <= set(rec)
                    assert set(rec["memory"]) == {"argument", "output",
                                                  "temp", "peak"}
                    assert rec["flops"] > 0 and rec["hlo_bytes"] > 0
                    assert rec["chips"] == 4 and rec["tp"] == 2
    # tp 2 shards llama2's heads and vocab: its gathers cross the model axis
    dec = seen["llama2-7b", "decode_32k", None]
    assert dec["coll_bytes"] > 0 and dec["batch"] == 128 // 2
    assert seen["rwkv6-3b", "long_500k", 4]["batch"] == 1   # not split
    # the quantized tree's GEMMs (wq, wk, wv, wo, the fused gate|up wi and
    # the FFN's wo a layer) are credited to the fused kernel
    assert seen["llama2-7b", "decode_32k", 4]["kernel_credits"][
        "rht_qmatmul"]["calls"] == 6 * get_tiny("llama2-7b").n_layers
    assert "rht_qmatmul" in seen["mixtral-8x7b", "prefill_32k", 4][
        "kernel_credits"]
    assert "grouped_rht_qmatmul" in seen["mixtral-8x7b", "prefill_32k", 4][
        "kernel_credits"]


def test_argument_bytes_are_the_ranks_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        _, meta, (params, caches, inputs) = dryrun.build_cell(
            "llama2-7b", "decode_32k", mesh=MESH, quant=None,
            device=torch.device("cpu"), tiny=True)
        tensors = []

        def walk(n):
            if isinstance(n, torch.Tensor):
                tensors.append(n)
            elif isinstance(n, dict):
                for v in n.values():
                    walk(v)
            elif isinstance(n, list):
                for v in n:
                    walk(v)
            elif dataclasses.is_dataclass(n):
                for f in dataclasses.fields(n):
                    walk(getattr(n, f.name))
        walk([params, caches, inputs])
        total = sum(t.numel() * t.element_size() for t in tensors)
        assert total == sum(dryrun._storages([params, caches,
                                              inputs]).values())
        cfg = get_tiny("llama2-7b")
        # the rank's KV rings hold half the KV heads of its batch share
        assert caches[0]["kv"].k.shape == (64, 32768, cfg.n_kv // 2, cfg.hd)
    rec = dryrun.count_cell("llama2-7b", "decode_32k", mesh=MESH, quant=None,
                            device=torch.device("cpu"), tiny=True)
    assert rec["memory"]["argument"] == total
    assert rec["memory"]["peak"] == total + rec["memory"]["temp"] + \
        rec["memory"]["output"]


def test_cli_refuses_the_unported_variants(capsys):
    for flag in ("--seqshard", "--shard-kv", "--shard-qkv",
                 "--remat-attention", "--expand-kv"):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "llama2-7b", flag])
        assert e.value.code == 2
        assert "ROADMAP Queue 1 item 8" in capsys.readouterr().err
    assert "llama2-7b" not in dryrun.REFERENCE_ARCHS
    assert set(dryrun.REFERENCE_ARCHS) == set(jreg.ARCH_IDS)


def test_report_renders_and_reanalyze_reproduces(tmp_path, capsys):
    art = _art(tmp_path)
    for shape in ("decode_32k", "long_500k", "train_4k"):
        dryrun.run_cell("recurrentgemma-2b", shape, quant=4, mesh=MESH,
                        tiny=True, device="cpu", art_dir=art, save_ops=True)
    table = report.dryrun_table("2x2", 4, art_dir=art)
    assert table.count("| recurrentgemma-2b |") == 3 and "SKIP" in table
    roof = report.roofline_table("2x2", 4, art_dir=art)
    assert roof.count("| recurrentgemma-2b |") == 2
    assert "recurrentgemma-2b" in troof.report("2x2", 4, art_dir=art)
    path = os.path.join(art, "recurrentgemma-2b__decode_32k__2x2__q4.json")
    with open(path) as f:
        before = json.load(f)
    tampered = dict(before, flops=0.0, hlo_bytes=0.0, coll_bytes=0.0,
                    coll_by_kind={}, kernel_credits={})
    with open(path, "w") as f:
        json.dump(tampered, f)
    assert reanalyze.main(art) == 2
    with open(path) as f:
        after = json.load(f)
    assert after == before

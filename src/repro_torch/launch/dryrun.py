"""Dry-run of every (arch x shape x mesh) cell on fake tensors (port of
``repro/launch/dryrun.py``): nothing is allocated, each cell's per-GPU
step is counted by ``launch/hlocost.py`` and recorded for the roofline
(``launch/roofline.py``) and its tables (``launch/report.py``).

The reference lowers and compiles each cell's global program under GSPMD
on a 16 x 16 TPU mesh and reads the per-device HLO.  The port has no
partitioner: a serve cell's per-GPU program is rank 0 of the port's own
tensor-parallel runtime (``runtime/tp.py``) on the H100 production mesh
(``launch/mesh.make_production_mesh``: data 32 x model 8).  ``tp`` is the
mesh's model size; the config's params are built in bf16 on fake tensors
(``--quant b``: ``quantize_params_uniform`` at b bits, shape-only), sliced
for rank 0 (``tp.prepare_params``), and the step is
``runtime/steps.make_prefill_step`` (prefill_32k) or ``make_serve_step``
(decode_32k, long_500k) under a dry-run TP group, whose gathers report
their bytes.  The batch is the global batch over the data-parallel axes
where they divide it, else all of it (the rules' ``_fit`` drops the axis,
so long_500k's batch of 1 is replicated).

Records (``artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__qN].json``)
keep the reference's keys: ``flops``, ``hlo_bytes`` (the counter's
bytes), ``coll_bytes``, ``coll_by_kind``, ``memory`` (``argument``: the
rank's params, caches and inputs; ``temp`` and ``peak`` from the
counter's storage tracker; ``output``: what the step returns that it
allocated), plus ``tp``, ``dp``, ``batch``, ``argument_specs`` (the bytes
per chip the ported GSPMD rules of ``runtime/sharding.py`` would hold),
``wo_bytes`` (the replicated ``wo`` / ``swo`` bytes of the rank) and
``kernel_credits``.

A train cell (train_4k) is rank 0 of the port's model-parallel training
(``runtime/steps.make_train_step(mesh=)``) on the same mesh: ZeRO-3 over
the data axis (dp = 32, the data-parallel axes' product) and tensor
parallelism over the model axis (tp = 8), on a dry-run ``TrainMesh``
whose collectives report their bytes by kind and axis (``coll_by_kind``;
``coll_by_axis``: the data axis's all-gathers and reduce-scatters, the
model axis's all-reduces).  The params are built in bf16, sliced and
sharded for rank 0 (``sharding.TrainLayout``), the moments are
``adamw_init``'s on the shards, and the step takes the rank's rows of the
global batch (256 -> 8) in ``--microbatches`` parts (the reference's
flag, default 4); the counter sees the backward too.  The attention and
MLA decoders count, dense and MoE: an MoE's experts go whole over the
model axis (expert parallelism, its combine all-reduced over model) and
its expert counts are all-gathered over data (``models/moe.py``).  The
RWKV6, RG-LRU and Whisper train cells are ``skip`` with the ROADMAP item
their families wait for (Queue 1 item 11: the recurrent mixers' and the
encoder-decoder's TP layout).  A cell that the port
cannot run is recorded as ``error`` with its reason.  The reference's
variants (``--remat-attention``, ``--expand-kv``, ``--seqshard``,
``--shard-kv``, ``--shard-qkv``) are refused: the port's models do not
read the first two and the other three need ``runtime/actsharding.py``
(ROADMAP Queue 1 item 8's rest).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu \\
      [--quant 4] [--multi-pod | --both-meshes] [--force] [--save-ops]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama2-7b \\
      --shape decode_32k

``--all`` takes the reference's arch list (``repro/configs/registry.py``
leaves llama2-7b out of ``ARCH_IDS``); ``--arch llama2-7b`` runs it.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, cell_applicable, input_specs
from repro_torch.configs.registry import ARCH_IDS, get_config, get_tiny
from repro_torch.launch import hlocost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import ART_DIR, CARD_BYTES
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import tp as tpmod

# the reference's --all list: its registry leaves the paper's llama2-7b out
REFERENCE_ARCHS = tuple(a for a in ARCH_IDS if a != "llama2-7b")
MICROBATCHES = 4                 # the reference's --microbatches default
VARIANTS = ("remat-attention", "expand-kv", "seqshard", "shard-kv",
            "shard-qkv")


def _storages(tree) -> dict:
    """storage key -> bytes of every tensor in ``tree`` (shared storages,
    as ``prepare_params``' replicated leaves are, once)."""
    out = {}

    def walk(node):
        if isinstance(node, torch.Tensor):
            st = node.untyped_storage()
            out[st._cdata] = st.nbytes()
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif hasattr(node, "__dataclass_fields__"):
            for k in node.__dataclass_fields__:
                walk(getattr(node, k))
    walk(tree)
    return out


def _wo_bytes(params: dict) -> int:
    """Bytes of the rank's ``wo`` / ``swo`` leaves (replicated under TP)."""
    total = 0
    for lp in params.get("layers", []) + params.get("enc_layers", []):
        for sub in lp.values():
            if isinstance(sub, dict):
                for k in ("wo", "swo"):
                    if k in sub:
                        total += sum(_storages(sub[k]).values())
    return total


def _dp(mesh) -> int:
    n = 1
    for a in shd.dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def _train_skip(cfg) -> str | None:
    """Why ``cfg``'s train cell is skipped, or None (it counts)."""
    try:
        tpmod.check_trainable(cfg)
    except ValueError as e:
        return "SKIP: " + str(e).split(": ", 1)[1]
    return None


def _build_train(cfg, arch, shape, *, mesh, quant, device, dtype, tiny,
                 microbatches):
    """(run, meta, arguments) of rank 0's train step on ``mesh`` (see the
    module docstring).  ``quant`` only labels the record: the reference
    trains its bf16 params under ``--quant`` too."""
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import make_train_step
    from repro_torch.tree import tree_map
    cell = SHAPES[shape]
    tp, dp = mesh.shape["model"], _dp(mesh)
    gb = cell.global_batch
    tmesh = shd.dryrun_mesh(dp, tp, device)
    params = tf.init_params(cfg, device=device, dtype=dtype)
    layout = shd.TrainLayout(cfg, tmesh)
    shards = layout.shard(params)
    opt = adamw_init(shards)
    batch = input_specs(cfg, shape, dtype, device=device)
    local = input_specs(cfg, shape, dtype, batch=gb // dp, device=device)
    step = make_train_step(cfg, microbatches=microbatches, mesh=tmesh)
    f32 = tree_map(lambda t: t.new_empty(t.shape, dtype=torch.float32),
                   params)
    p_specs = shd.param_specs(params, mesh, serve=False,
                              period=cfg.scan_period)
    spec_bytes = (shd.bytes_per_chip(params, p_specs, mesh)
                  + 2 * shd.bytes_per_chip(f32, p_specs, mesh)
                  + shd.bytes_per_chip(batch, shd.batch_specs(batch, mesh),
                                       mesh))
    meta = dict(arch=arch, shape=shape, kind=cell.kind, mesh=mesh.name,
                chips=mesh.size, seq_len=cell.seq_len, global_batch=gb,
                quant=quant, tp=tp, dp=dp, batch=gb // dp,
                microbatches=microbatches, tp_plan=layout.plan.asdict(),
                argument_specs=int(spec_bytes), wo_bytes=_wo_bytes(shards),
                coll_axis="data+model",
                device=str(torch.device(device).type),
                dtype=str(dtype).split(".")[-1], tiny=tiny)

    def run():
        return step(shards, opt, batch)
    return run, meta, (shards, opt, local)


def build_cell(arch: str, shape: str, *, mesh, quant: int | None,
               device, dtype=torch.bfloat16, tiny: bool = False,
               microbatches: int = MICROBATCHES):
    """(run, meta, arguments) for one cell, built on fake tensors (the
    caller holds the ``FakeTensorMode``): ``run()`` is rank 0's step,
    ``arguments`` what it reads (params, caches, inputs; a train cell's
    rank reads its rows of the batch), ``meta`` the record's fields so
    far."""
    from repro_torch.core.pipeline import quantize_params_uniform
    from repro_torch.models import decode as decmod
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import linear
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step
    cfg = (get_tiny if tiny else get_config)(arch)
    cell = SHAPES[shape]
    if cell.kind == "train":
        return _build_train(cfg, arch, shape, mesh=mesh, quant=quant,
                            device=device, dtype=dtype, tiny=tiny,
                            microbatches=microbatches)
    tp = mesh.shape["model"]
    dp = _dp(mesh)
    gb = cell.global_batch
    batch = gb // dp if gb % dp == 0 else gb
    params = tf.init_params(cfg, device=device, dtype=dtype)
    if quant is not None:
        params = quantize_params_uniform(cfg, params, quant, device=device)
    plan = tpmod.plan_for(cfg, tp)
    rank = tpmod.prepare_params(cfg, params, 0, tp)
    kv_heads = tpmod.local_kv_heads(cfg, plan)
    inputs = input_specs(cfg, shape, dtype, batch=batch, device=device)
    spec_bytes = shd.bytes_per_chip(
        params, shd.param_specs(params, mesh, serve=True,
                                period=cfg.scan_period), mesh)
    g_inputs = input_specs(cfg, shape, dtype, device=device)
    spec_bytes += shd.bytes_per_chip(g_inputs, shd.batch_specs(g_inputs, mesh),
                                     mesh)
    if cell.kind == "prefill":
        step = make_prefill_step(cfg, context=cell.seq_len, cache_dtype=dtype,
                                 kv_heads=kv_heads)
        arguments = (rank, inputs)

        def run():
            return step(rank, inputs)
    else:
        def caches_for(b, heads, p):
            caches = decmod.init_caches(cfg, b, cell.seq_len, dtype, device,
                                        kv_heads=heads)
            if cfg.enc_dec:             # the cross K/V prefill would cache
                enc = torch.empty((b, cfg.n_audio_ctx, cfg.d_model),
                                  dtype=dtype, device=device)
                for lp, c in zip(p["layers"], caches):
                    for key, w in (("xk", "wk"), ("xv", "wv")):
                        c[key] = linear(lp["xattn"][w], enc).reshape(
                            b, cfg.n_audio_ctx, cfg.n_kv, cfg.hd)
            return caches
        caches = caches_for(batch, kv_heads, rank)
        g_caches = caches_for(gb, None, params)
        spec_bytes += shd.bytes_per_chip(
            g_caches, shd.cache_specs(g_caches, mesh), mesh)
        del g_caches
        step = make_serve_step(cfg)
        arguments = (rank, caches, inputs)

        def run():
            return step(rank, caches, inputs["tokens"], inputs["pos"])
    meta = dict(arch=arch, shape=shape, kind=cell.kind, mesh=mesh.name,
                chips=mesh.size, seq_len=cell.seq_len, global_batch=gb,
                quant=quant, tp=tp, dp=dp, batch=batch,
                tp_plan=plan.asdict(), argument_specs=int(spec_bytes),
                wo_bytes=_wo_bytes(rank), coll_axis="model",
                device=str(torch.device(device).type),
                dtype=str(dtype).split(".")[-1], tiny=tiny)
    return run, meta, arguments


def count_cell(arch: str, shape: str, *, mesh, quant: int | None, device,
               save_ops: bool = False, tiny: bool = False,
               microbatches: int = MICROBATCHES) -> dict:
    """Build and count one cell on fake tensors -> the record's fields
    (and ``ops``, the trace, with ``save_ops``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        run, meta, arguments = build_cell(arch, shape, mesh=mesh,
                                          quant=quant, device=device,
                                          tiny=tiny,
                                          microbatches=microbatches)
        t_build = time.time() - t0
        argument = _storages(arguments)
        with tpmod.scope(tpmod.dryrun_group(meta["tp"], device)), \
                hlocost.CostCounter(trace=save_ops) as cc:
            out = run()
        new = {k: v for k, v in _storages(out).items() if k not in argument}
        temp_peak = cc.mem.peak
        del out, run, arguments
    tot = cc.totals()
    out_b = sum(new.values())
    arg_b = sum(argument.values())
    rec = dict(status="ok", **meta, build_s=round(t_build, 2),
               count_s=round(time.time() - t0 - t_build, 2),
               flops=tot["flops"], hlo_bytes=tot["bytes"],
               coll_bytes=tot["coll_bytes"], coll_by_kind=tot["coll_by_kind"],
               unknown_trip_whiles=0, kernel_credits=tot["kernel_credits"],
               memory=dict(argument=arg_b, output=out_b,
                           temp=max(temp_peak - out_b, 0),
                           peak=arg_b + temp_peak))
    if meta["kind"] == "train":
        rec["coll_by_axis"] = tot["coll_by_axis"]
    rec["fits"] = rec["memory"]["peak"] <= CARD_BYTES
    if save_ops:
        rec["ops"] = cc.ops_trace()
    return rec


def _tag(arch, shape, meshname, quant) -> str:
    return f"{arch}__{shape}__{meshname}" + (f"__q{quant}" if quant else "")


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             quant: int | None = None, force: bool = False, device=None,
             save_ops: bool = False, mesh=None, tiny: bool = False,
             art_dir: str | None = None,
             microbatches: int = MICROBATCHES) -> dict:
    """One cell's record, from ``art_dir`` if it is there (unless
    ``force``), else counted and written.  ``mesh`` replaces the
    production mesh (tests: a small one); ``tiny`` counts the arch's tiny
    config.  ``device``: where the fake tensors live (CUDA unless
    ``"cpu"``; the counts do not depend on it)."""
    from repro_torch import resolve_device
    art_dir = art_dir or ART_DIR
    os.makedirs(art_dir, exist_ok=True)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    tag = _tag(arch, shape, mesh.name, quant)
    path = os.path.join(art_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = (get_tiny if tiny else get_config)(arch)
    ok, why = cell_applicable(cfg, shape)
    if ok and SHAPES[shape].kind == "train":
        why = _train_skip(cfg)
        ok = why is None
    rec = None
    if not ok:
        rec = dict(arch=arch, shape=shape, mesh=mesh.name, status="skip",
                   reason=why, quant=quant)
    else:
        try:
            rec = count_cell(arch, shape, mesh=mesh, quant=quant,
                             device=resolve_device(device),
                             save_ops=save_ops, tiny=tiny,
                             microbatches=microbatches)
        except Exception as e:       # recorded, never hidden
            rec = dict(arch=arch, shape=shape, mesh=mesh.name,
                       status="error", quant=quant,
                       error=f"{type(e).__name__}: {e}",
                       trace=traceback.format_exc()[-4000:])
    ops = rec.pop("ops", None)
    if ops is not None:
        with open(os.path.join(art_dir, tag + ".ops.json"), "w") as f:
            json.dump(ops, f)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quant", type=int, default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-ops", action="store_true")
    ap.add_argument("--microbatches", type=int, default=MICROBATCHES,
                    help="a train cell's microbatches (the reference's)")
    ap.add_argument("--device", default=None,
                    help="where the fake tensors live (default cuda)")
    for v in VARIANTS:
        ap.add_argument(f"--{v}", action="store_true")
    args = ap.parse_args(argv)
    refused = [v for v in VARIANTS if getattr(args, v.replace("-", "_"))]
    if refused:
        ap.error(f"--{refused[0]} is not ported: the port's models do not "
                 f"read remat_attention / expand_kv, and the activation "
                 f"constraints need runtime/actsharding.py (ROADMAP Queue 1 "
                 f"item 8)")
    if args.arch and args.arch not in ARCH_IDS:
        ap.error(f"unknown arch {args.arch!r}; known: {sorted(ARCH_IDS)}")
    if args.shape and args.shape not in SHAPES:
        ap.error(f"unknown shape {args.shape!r}; known: {sorted(SHAPES)}")
    archs = list(REFERENCE_ARCHS) if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [bool(args.multi_pod)]
    n = {"ok": 0, "skip": 0, "error": 0}
    for a in archs:
        for s in shapes:
            for mp in meshes:
                rec = run_cell(a, s, multi_pod=mp, quant=args.quant,
                               force=args.force, device=args.device,
                               save_ops=args.save_ops,
                               microbatches=args.microbatches)
                status = rec["status"]
                n[status] += 1
                extra = ""
                if status == "ok":
                    extra = (f"flops={rec['flops']:.3e} "
                             f"bytes={rec['hlo_bytes']:.3e} "
                             f"coll={rec['coll_bytes']:.3e} "
                             f"peak={rec['memory']['peak'] / 2**30:.2f}GiB "
                             f"count={rec['count_s']}s")
                elif status == "error":
                    extra = rec["error"][:160]
                print(f"[{status:5s}] {a} {s} {rec['mesh']}"
                      + (f" q{args.quant}" if args.quant else "") + " "
                      + extra, flush=True)
    print(f"done: {n['ok']} ok, {n['skip']} skip, {n['error']} error")
    if n["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

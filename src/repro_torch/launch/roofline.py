"""Roofline of the dry-run's records on the H100 (port of
``repro/launch/roofline.py``), and the yardstick every bound of the port
is read against.

Hardware constants, H100 SXM5 80 GB at 700 W, per GPU (NVIDIA H100 Tensor
Core GPU data sheet; dense rates, no sparsity):

    PEAK_FLOPS  989 TFLOP/s  bf16 on the tensor cores
    HBM_BW      3.35 TB/s    HBM3
    NVLINK_BW   450 GB/s     NVLink 4, each way (900 GB/s bidirectional):
                             the model axis, inside an 8-GPU node
    IB_BW       50 GB/s      one 400 Gb/s InfiniBand NDR port per GPU
                             (ConnectX-7): the data and pod axes

A record's counts are per GPU (the dry-run counts one rank's program), so

    T_compute = flops / PEAK_FLOPS
    T_memory  = bytes / HBM_BW
    T_coll    = collective bytes / the bandwidth of the link they cross

The port's collectives are the TP gathers over the model axis (NVLink);
serving has no data-axis traffic.  MODEL_FLOPS, the useful work:
train 6 N_active tokens, prefill 2 N_active tokens, decode 2 N_active
per sequence, over the chips.

``RATES`` holds the peak rate for each kind of operation a kernel's bound
counts (``kernels/*/ops.cost``); ``bound`` turns a cost into the least
time the card could take for it.
"""
from __future__ import annotations

import dataclasses
import functools
import glob
import json
import os

PEAK_FLOPS = 989e12        # bf16 dense, tensor cores
HBM_BW = 3.35e12           # B/s
NVLINK_BW = 450e9          # B/s each way, NVLink 4 (model axis)
IB_BW = 50e9               # B/s per GPU, InfiniBand NDR (data axis)
LINK_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}
CARD_BYTES = 80e9          # one H100's device memory

# the peak rate for what an operation's operands are (NVIDIA data sheet,
# dense): a kernel's cost names one of these per term of its work
BF16 = "bf16 989 TFLOP/s"
CODES = "f32 x codes 3 x bf16 330 TFLOP/s"
F32 = "f32 3 x TF32 165 TFLOP/s"
SIMT = "f32 CUDA cores 67 TFLOP/s"
SIMT_ISSUE = "f32 CUDA-core instructions 33.5 T/s"
RATES = {
    # bf16 x bf16 on the tensor cores
    BF16: 989e12,
    # f32 x RaBitQ codes (or x +-1 signs): the codes are integers 0-255,
    # exact in bf16, and three bf16 terms hold an f32 significand
    CODES: 989e12 / 3,
    # f32 x f32: three TF32 products per product
    F32: 495e12 / 3,
    # f32 element-wise work with no product to put on the tensor cores
    SIMT: 67e12,
    # f32 instructions issued on the CUDA cores, each counted once (the
    # 67 TFLOP/s peak counts an fma as two operations)
    SIMT_ISSUE: 67e12 / 2,
}

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")


def bound(nbytes: float, *work: tuple[float, str]) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate for their operands
    (``work``: (operations, rate name) pairs, their times summed)."""
    t_bytes = nbytes / HBM_BW
    t_ops = sum(ops / RATES[rate] for ops, rate in work)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_rate": " + ".join(dict.fromkeys(
                rate for ops, rate in work if ops))}


def cost_bound(cost: dict) -> dict:
    """``bound`` of a kernel's ``cost(...)``."""
    return bound(cost["bytes"], *[tuple(w) for w in cost["work"]])


# ------------------------------------------------------ whole-step bounds

QUANT_TENSORS = ("packed", "rescale", "signs1", "signs2", "mean_col", "w_out",
                 "out_idx", "keep_idx")


def quantized_linears(params) -> dict:
    """name -> QuantizedLinear (or QuantizedGrouped), under the pipeline's
    names (``L3.attn.wq``, ``L2.moe.wi``, Whisper's ``enc5.mlp.wo``)."""
    from repro_torch.core.pipeline import SCOPES
    return {f"{scope}{i}.{g}.{k}": sub[k]
            for scope, key in SCOPES
            for i, lp in enumerate(params.get(key, ()))
            for g, sub in lp.items() if isinstance(sub, dict) for k in sub
            if hasattr(sub[k], "packed")}


def quant_bytes(q, names=QUANT_TENSORS) -> int:
    return sum(t.numel() * t.element_size()
               for t in (getattr(q, n, None) for n in names) if t is not None)


def decode_step_bound_ms(cfg, params, tokens_in_arena: float,
                         slots: int = 8) -> float:
    """Least time of one decode step: every weight byte (packed codes, side
    info, every expert's codes, the layers' full-precision leaves: norms,
    MoE routers, MLA's wkv_b, RWKV's LoRAs, RG-LRU's gates; the f32
    lm_head, the embedding rows read), every live K/V byte (an attention
    layer's K and V, an MLA layer's latent and rotary key, per token in
    the arena) and each slot's recurrent state (read and written) once,
    over the HBM rate."""
    import torch

    from repro_torch import tree as ptree
    nbytes = params["lm_head"].numel() * 4 + slots * cfg.d_model * 4
    nbytes += sum(quant_bytes(q) for q in quantized_linears(params).values())
    nbytes += sum(t.numel() * t.element_size() for lp in params["layers"]
                  for t in ptree.leaves(lp) if isinstance(t, torch.Tensor))
    per_token, state = 0, 0
    for mixer in cfg.pattern:
        if mixer == "attn":
            per_token += 2 * cfg.n_kv * cfg.hd * 4
        elif mixer == "mla":
            per_token += (cfg.mla.kv_lora + cfg.mla.qk_rope) * 4
        elif mixer == "rwkv":
            state += 2 * (cfg.n_heads * cfg.hd * cfg.hd + 2 * cfg.d_model) * 4
        elif mixer == "rglru":
            state += 2 * 4 * (cfg.rglru_width or cfg.d_model) * 4
    nbytes += slots * state
    return (nbytes + tokens_in_arena * per_token) / HBM_BW * 1e3


# -------------------------------------------------------------- roofline


def _names_numel(node, names=()):
    """(path names, numel) of every tensor in a param tree."""
    import torch
    if isinstance(node, torch.Tensor):
        yield list(names), node.numel()
    elif isinstance(node, dict):
        for k, v in node.items():
            yield from _names_numel(v, names + (str(k),))
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _names_numel(v, names + ("",))


@functools.lru_cache(maxsize=None)
def count_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts, embed and lm_head excluded (the
    6ND convention).  The config's params are built on fake tensors
    (nothing is allocated) and only their shapes are read."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import transformer as tf
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = tf.init_params(cfg, device="cpu")
    total = active = moe_total = moe_active = 0
    for names, n in _names_numel(params):
        if "embed" in names or "lm_head" in names:
            continue
        total += n
        if "moe" in names and names[-1] in ("wi", "wo"):
            moe_total += n
            moe_active += n * cfg.moe.top_k // cfg.moe.n_experts
        else:
            active += n
    return total + moe_total, active + moe_active


@dataclasses.dataclass
class Roofline:
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops_per_chip: float
    useful_ratio: float      # MODEL_FLOPS / counted flops (per chip)
    roofline_frac: float     # bound from useful work / the largest term

    def as_dict(self):
        return dataclasses.asdict(self)


def model_flops(cfg, kind: str, seq_len: int, global_batch: int) -> float:
    total, active = count_params(cfg)
    if kind == "train":
        return 6.0 * active * seq_len * global_batch
    if kind == "prefill":
        return 2.0 * active * seq_len * global_batch
    return 2.0 * active * global_batch          # decode: one token/seq


def coll_bw(rec: dict) -> float:
    """The bandwidth of the link a record's collectives cross (its
    ``coll_axis``; the TP gathers' model axis, NVLink, by default)."""
    return LINK_BW[rec.get("coll_axis") or "model"]


def coll_time(rec: dict) -> float:
    """Seconds the record's collectives take on their links: each axis's
    bytes over its link (``coll_by_axis``, a train cell's), else all of
    them over ``coll_bw``."""
    if "coll_by_axis" in rec:
        return sum(sum(kinds.values()) / LINK_BW[axis]
                   for axis, kinds in rec["coll_by_axis"].items())
    return rec.get("coll_bytes", 0) / coll_bw(rec)


def analyze(rec: dict, cfg) -> Roofline:
    chips = rec["chips"]
    t_c = rec["flops"] / PEAK_FLOPS
    t_m = rec["hlo_bytes"] / HBM_BW
    t_l = coll_time(rec)
    dominant = max(("compute", t_c), ("memory", t_m),
                   ("collective", t_l), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, rec["kind"], rec["seq_len"], rec["global_batch"])
    mf_chip = mf / chips
    useful = mf_chip / max(rec["flops"], 1.0)
    # the time a perfect implementation of the useful work would need
    t_useful = max(mf_chip / PEAK_FLOPS, _min_bytes(cfg, rec) / HBM_BW)
    frac = t_useful / max(t_c, t_m, t_l, 1e-30)
    return Roofline(t_compute=t_c, t_memory=t_m, t_collective=t_l,
                    dominant=dominant, model_flops_per_chip=mf_chip,
                    useful_ratio=useful, roofline_frac=min(frac, 1.0))


def _min_bytes(cfg, rec) -> float:
    """Lower bound on per-chip bytes: weights touched once, bf16 unless
    quantized codes."""
    total, _ = count_params(cfg)
    wbytes = 2.0 * total
    if rec.get("quant"):
        wbytes = total * rec["quant"] / 8.0
    return wbytes / rec["chips"]


def load_records(mesh: str = "32x8", quant=None, variant: str = "",
                 art_dir: str | None = None) -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(art_dir or ART_DIR, "*.json"))):
        if f.endswith(".ops.json"):
            continue
        with open(f) as fh:
            r = json.load(fh)
        if r.get("mesh") != mesh:
            continue
        if (r.get("quant") or None) != quant:
            continue
        if (r.get("variant") or "") != variant:
            continue
        recs.append(r)
    return recs


def record_config(rec: dict):
    """The config a record counted (its arch's tiny one for a tiny run)."""
    from repro_torch.configs.registry import get_config, get_tiny
    return (get_tiny if rec.get("tiny") else get_config)(rec["arch"])


def report(mesh: str = "32x8", quant=None, art_dir: str | None = None) -> str:
    rows = []
    hdr = (f"{'arch':20s} {'shape':12s} {'dom':10s} {'T_comp(ms)':>10s} "
           f"{'T_mem(ms)':>10s} {'T_coll(ms)':>10s} {'useful':>7s} "
           f"{'roofline':>8s}")
    rows.append(hdr)
    rows.append("-" * len(hdr))
    for r in load_records(mesh, quant, art_dir=art_dir):
        if r["status"] == "skip":
            rows.append(f"{r['arch']:20s} {r['shape']:12s} SKIP "
                        f"({r['reason'][:60]})")
            continue
        if r["status"] != "ok":
            rows.append(f"{r['arch']:20s} {r['shape']:12s} ERROR "
                        f"{r['error'][:60]}")
            continue
        rl = analyze(r, record_config(r))
        rows.append(
            f"{r['arch']:20s} {r['shape']:12s} {rl.dominant:10s} "
            f"{rl.t_compute*1e3:10.3f} {rl.t_memory*1e3:10.3f} "
            f"{rl.t_collective*1e3:10.3f} {rl.useful_ratio:7.3f} "
            f"{rl.roofline_frac:8.3f}")
    return "\n".join(rows)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="32x8")
    ap.add_argument("--quant", type=int, default=None)
    args = ap.parse_args()
    print(report(args.mesh, args.quant))

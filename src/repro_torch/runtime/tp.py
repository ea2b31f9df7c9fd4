"""Tensor-parallel serving over ``torch.distributed`` (port of
``repro/runtime/tp.py``, DESIGN.md §11).

The partitioning is the reference's, chosen for the *quantized*
representation: a RaanA weight's rows are entangled by the randomized
Hadamard transform, but its output columns are independent (each column
owns its packed codes, its ``rescale`` entry and its ``w_out`` outlier
column).  So every sharded weight is sharded by output column and each TP
boundary is an all_gather of disjoint slices, never a sum of partial
products:

  * attention ``wq``/``wk``/``wv`` by head (the KV arenas hold the rank's
    heads, ``local_kv_heads``); ``wo`` replicated behind ``gather_heads``;
  * the fused gate|up ``wi`` (dense, MoE expert, shared expert) by FFN
    column, after ``_glu_perm`` interleaves per-rank [gate_i | up_i]
    blocks; ``wo`` replicated behind ``gather_cols``;
  * ``lm_head`` by vocab, the logits gathered once per step.

Every column is computed by one rank with the single-device ops, so greedy
tokens at TP=2 equal TP=1.  Two things keep that exact on the card, where
the kernels plan their reductions from their widths: a sliced
``QuantizedLinear`` / ``QuantizedGrouped`` keeps its full static ``c``,
which the dequant GEMM plans its split of d from
(``kernels/qmatmul/ops.split_plan``), and the engine names the full KV-head
count to the paged attention read (``pops.plan_heads``), so each column and
head reduces in the order it does at TP=1.

The reference runs one controller over a ``shard_map``; the port runs one
process per rank.  Rank 0's ``PagedServer`` keeps every piece of host
state (scheduler, allocator, prefix cache, sampling) and, before each
device op, broadcasts the op's key and host inputs (``send_op``); the other
ranks run the same op on their shard (``PagedServer.serve_worker``) and
take part in the gathers.  ``scope`` makes a ``TPGroup`` the one the
gathers use; outside one, and wherever the local dim is already full (TP=1,
a replicated family), the gathers are shape-driven no-ops, so TP=1 is the
same code path.  ``launch/mesh.py`` builds the group and spawns ranks.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.qlinear import QuantizedGrouped, QuantizedLinear

# ------------------------------------------------------------------- plan


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """Which weight families shard at this TP degree (the rest replicate).
    Attention is all-or-nothing: ``wq``/``wk``/``wv`` and the KV arena
    shard together or not at all, so the GQA group ratio is the same on
    every rank."""
    tp: int
    attn: bool       # wq/wk/wv by head + KV arena head axis
    ffn: bool        # dense glu/gelu wi by FFN column
    moe: bool        # expert wi by per-expert FFN column
    shared: bool     # shared-expert swi by FFN column
    lm_head: bool    # vocab columns (logits gathered once per step)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def plan_for(cfg, tp: int) -> TPPlan:
    moe = cfg.moe
    return TPPlan(
        tp=tp,
        attn=tp > 1 and cfg.n_heads % tp == 0 and cfg.n_kv % tp == 0,
        ffn=tp > 1 and cfg.moe is None and cfg.d_ff % tp == 0,
        moe=tp > 1 and moe is not None and moe.d_ff_expert % tp == 0,
        shared=(tp > 1 and moe is not None and moe.n_shared > 0
                and (moe.d_ff_expert * moe.n_shared) % tp == 0),
        lm_head=tp > 1 and cfg.vocab % tp == 0)


def local_kv_heads(cfg, plan: TPPlan) -> int:
    """KV heads of this rank's attention arenas (the reference's
    ``cache_spec_list``): ``n_kv / tp`` when the plan shards attention,
    else all of them.  MLA and recurrent per-slot state replicates."""
    return cfg.n_kv // plan.tp if plan.attn else cfg.n_kv


# ------------------------------------------------------------------ group


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """One rank's view of a TP group (``launch/mesh.make_host_mesh``).
    ``pg`` carries the gathers (gloo or NCCL); ``ctrl`` is a gloo group
    over the same ranks for the host messages (the same group under
    gloo).  A group of size 1 has neither."""
    rank: int
    size: int
    backend: str | None
    device: torch.device
    pg: Any = None
    ctrl: Any = None


_GROUP: contextvars.ContextVar[TPGroup | None] = contextvars.ContextVar(
    "repro_torch_tp_group", default=None)


@contextlib.contextmanager
def scope(group: TPGroup | None):
    """Scoped: the gathers run over ``group`` (None: no group, so a gather
    of a sliced tensor raises).  Nests and unwinds."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


DRYRUN = "dryrun"


def dryrun_group(tp: int, device) -> TPGroup:
    """Rank 0 of a ``tp``-rank group that joins no process: its gathers
    take fake tensors only, return the gathered shape and report the
    result's bytes to the cost counters (``launch/dryrun.py``)."""
    return TPGroup(rank=0, size=tp, backend=DRYRUN,
                   device=torch.device(device))


def _all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The group's slices of ``x`` concatenated along ``dim`` in rank
    order.  Under gloo a CUDA tensor goes through the host."""
    import torch.distributed as dist
    group = _GROUP.get()
    if group is None or group.size == 1:
        raise RuntimeError(f"a sliced tensor {tuple(x.shape)} reached a TP "
                           f"gather outside a TP group's scope")
    if group.backend == DRYRUN:
        from repro_torch import kernels
        if not kernels.is_fake(x):
            raise RuntimeError("a dry-run group gathers fake tensors only")
        shape = list(x.shape)
        shape[dim] *= group.size
        out = x.new_empty(shape)
        kernels.collective("all-gather", out.numel() * out.element_size())
        return out
    send = x.contiguous()
    host = group.backend == "gloo" and send.is_cuda
    if host:
        send = send.cpu()
    parts = [torch.empty_like(send) for _ in range(group.size)]
    dist.all_gather(parts, send, group=group.pg)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if host else out


def gather_heads(x: torch.Tensor, full_heads: int) -> torch.Tensor:
    """(..., H_loc, hd) -> (..., H, hd): concatenate the ranks' head
    slices.  A no-op when the heads are already full (TP=1 or replicated
    attention), so callers need no TP flag."""
    if x.shape[-2] == full_heads:
        return x
    return _all_gather(x, x.ndim - 2)


def gather_cols(y: torch.Tensor, full_dim: int) -> torch.Tensor:
    """(..., c_loc) -> (..., c): concatenate the ranks' column slices (FFN
    hidden states, logits).  A no-op when already full."""
    if y.shape[-1] == full_dim:
        return y
    return _all_gather(y, y.ndim - 1)


def in_dim(w) -> int:
    """Full input width of a 2-D weight (a tensor or a QuantizedLinear)."""
    return w.d if isinstance(w, QuantizedLinear) else int(w.shape[0])


# ------------------------------------------------------ host messages


def send_op(group: TPGroup, key, inputs) -> None:
    """Rank 0: the next device op's key and host inputs to every rank
    (``key`` None stops the workers)."""
    import torch.distributed as dist
    dist.broadcast_object_list([key, inputs], src=0, group=group.ctrl)


def recv_op(group: TPGroup) -> tuple:
    """A worker: (key, inputs) of rank 0's next device op."""
    import torch.distributed as dist
    msg = [None, None]
    dist.broadcast_object_list(msg, src=0, group=group.ctrl)
    return msg[0], msg[1]


# ---------------------------------------------------------- param slicing

# column-sharded weight keys, gated by the plan flag that owns them; the
# quantized-leaf fields of a sharded weight that slice along the column
# axis (everything else: signs, outlier indices, mean column, replicates)
_SHARDED_FIELDS = ("packed", "rescale", "w_out")
_REPLICATED_FIELDS = ("signs1", "signs2", "mean_col", "out_idx", "keep_idx")


def _decision(plan: TPPlan, names: list[str]):
    """(shard, glu_permute) for the weight node at path ``names``."""
    if "attn" in names and any(k in names for k in ("wq", "wk", "wv")):
        return plan.attn, False
    if "swi" in names:
        return plan.shared, True
    if "wi" in names:
        if "moe" in names:
            return plan.moe, True
        if "mlp" in names:
            # permute only for fused gate|up layouts: prepare_params drops
            # the flag for plain-gelu archs
            return plan.ffn, True
    if "lm_head" in names:
        return plan.lm_head, False
    return False, False


def _glu_perm(two_f: int, tp: int) -> np.ndarray:
    """Column permutation taking a fused [gate | up] layout (2f columns) to
    interleaved per-rank [gate_i | up_i] blocks, so rank i's local
    ``chunk(gu, 2)`` yields gate and up columns [i*f/tp, (i+1)*f/tp) and
    the gathered hidden state lands in natural column order.  Exact for
    quantized leaves too: codes, rescale and outlier rows are per column."""
    f = two_f // 2
    fl = f // tp
    return np.concatenate([
        np.concatenate([np.arange(i * fl, (i + 1) * fl),
                        f + np.arange(i * fl, (i + 1) * fl)])
        for i in range(tp)])


def _columns(c: int, rank: int, tp: int, permute: bool) -> np.ndarray:
    """The full-width columns rank ``rank`` holds, in its local order."""
    cols = _glu_perm(c, tp) if permute else np.arange(c)
    return cols[rank * (c // tp):(rank + 1) * (c // tp)]


def _take(t: torch.Tensor, cols: np.ndarray) -> torch.Tensor:
    idx = torch.from_numpy(cols).to(t.device)
    return t.index_select(t.ndim - 1, idx).contiguous()


def _shard(node, rank: int, tp: int, permute: bool):
    """Rank ``rank``'s column slice of one weight node.  A dim that does
    not divide ``tp`` replicates (the reference's ``_fit``).  A quantized
    node slices ``_SHARDED_FIELDS``, shares the rest and keeps its full
    static ``c`` (the GEMM's planning width)."""
    if isinstance(node, (QuantizedLinear, QuantizedGrouped)):
        c = node.rescale.shape[-1]
        if c % tp:
            return node
        cols = _columns(c, rank, tp, permute)
        return dataclasses.replace(node, **{
            f: _take(getattr(node, f), cols) for f in _SHARDED_FIELDS
            if getattr(node, f, None) is not None})
    if not isinstance(node, torch.Tensor) or node.ndim == 0:
        return node
    c = node.shape[-1]
    if c % tp:
        return node
    return _take(node, _columns(c, rank, tp, permute))


def prepare_params(cfg, params: dict, rank: int, tp: int) -> dict:
    """This rank's param tree for TP serving: every weight whose plan flag
    is on sliced along its last (output-column) axis, after the gate|up
    interleave for fused glu ``wi`` / ``swi``; everything else is the
    caller's tensor, shared.  At TP=1 (or with nothing to shard) the tree
    comes back as it is."""
    plan = plan_for(cfg, tp)
    if not any(v for k, v in plan.asdict().items() if k != "tp"):
        return params
    glu_ffn = cfg.ffn_kind() != "gelu"       # fused gate|up wi

    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + [str(k)]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, names + [str(i)]) for i, v in enumerate(node)]
        shard, glu = _decision(plan, names)
        if not shard:
            return node
        return _shard(node, rank, tp, glu and glu_ffn)
    return walk(params, [])

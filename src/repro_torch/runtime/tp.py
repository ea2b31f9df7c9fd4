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
    over the same ranks for the host messages, whose wait for one ends
    after ``ctrl_timeout_s``.  A group of size 1 has neither."""
    rank: int
    size: int
    backend: str | None
    device: torch.device
    pg: Any = None
    ctrl: Any = None
    ctrl_timeout_s: float | None = None
    axis: str = "model"      # the mesh axis it spans (a dry run's label)


_GROUP: contextvars.ContextVar[TPGroup | None] = contextvars.ContextVar(
    "repro_torch_tp_group", default=None)
_DATA: contextvars.ContextVar[TPGroup | None] = contextvars.ContextVar(
    "repro_torch_data_group", default=None)


@contextlib.contextmanager
def scope(group: TPGroup | None, data: TPGroup | None = None):
    """Scoped: the gathers run over ``group`` (None: no group, so a gather
    of a sliced tensor raises); ``data`` is a training mesh's data group,
    over which the MoE's router statistics are gathered (None: serving,
    or one device).  Nests and unwinds."""
    token, dtoken = _GROUP.set(group), _DATA.set(data)
    try:
        yield
    finally:
        _DATA.reset(dtoken)
        _GROUP.reset(token)


def current_group() -> TPGroup | None:
    """The group of the innermost ``scope`` (None outside one)."""
    return _GROUP.get()


def current_data_group() -> TPGroup | None:
    """The data group of the innermost ``scope`` (None outside one)."""
    return _DATA.get()


DRYRUN = "dryrun"


def dryrun_group(tp: int, device, axis: str = "model") -> TPGroup:
    """Rank 0 of a ``tp``-rank group that joins no process: its gathers
    and the training collectives below take fake tensors only, return the
    result's shape and report their bytes to the cost counters under
    ``axis`` (``launch/dryrun.py``)."""
    return TPGroup(rank=0, size=tp, backend=DRYRUN,
                   device=torch.device(device), axis=axis)


def through_host(group: TPGroup, x: torch.Tensor) -> bool:
    """Whether a collective of ``x`` over ``group`` runs on a host copy
    (gloo takes no CUDA tensor)."""
    return group.backend == "gloo" and x.is_cuda


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
        kernels.collective("all-gather", out.numel() * out.element_size(),
                           group.axis)
        return out
    send = x.contiguous()
    host = through_host(group, send)
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


# the key of rank 0's no-op message: an idle driver sends it at least
# every HEARTBEAT_FRACTION of the ctrl timeout, so a worker waiting for its
# next op never reaches the timeout (``PagedServer.keepalive``)
HEARTBEAT = ("heartbeat",)
HEARTBEAT_FRACTION = 0.1


def send_op(group: TPGroup, key, inputs) -> None:
    """Rank 0: the next device op's key and host inputs to every rank
    (``key`` None stops the workers, HEARTBEAT is a no-op)."""
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


def _walk_leaves(node, names, fn):
    """``node``'s dicts and lists rebuilt with each leaf (a tensor or a
    quantized weight) replaced by ``fn(path of keys, leaf)``."""
    if isinstance(node, dict):
        return {k: _walk_leaves(v, names + [str(k)], fn)
                for k, v in node.items()}
    if isinstance(node, list):
        return [_walk_leaves(v, names + [str(i)], fn)
                for i, v in enumerate(node)]
    return fn(names, node)


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

    def cut(names, node):
        shard, glu = _decision(plan, names)
        if not shard:
            return node
        return _shard(node, rank, tp, glu and glu_ffn)
    return _walk_leaves(params, [], cut)


# ------------------------------------------------------- training layout
#
# Training weights are dense, so the training layout is the reference's
# GSPMD rules (``runtime/sharding.py``'s ``_param_rule``): wq/wk/wv and the
# fused gate|up ``wi`` by output column, the attention and FFN ``wo`` by
# input row, ``lm_head`` by vocab column.  A row-sliced ``wo`` yields a
# partial sum on each rank, which ``reduce_from_model`` all-reduces;
# ``copy_to_model`` in front of each column-sliced linear all-reduces its
# input's gradient.  Attention stays all-or-nothing by ``plan_for``, as in
# serving; a family the plan leaves whole replicates.
#
# The MoE's routed experts go whole over the model axis when it divides
# their count (expert parallelism: ``wi`` / ``wo`` on their expert axis),
# else by column and row within each expert (``wi`` by glu-permuted
# column, ``wo`` by row), the reference's ``_fit`` fallback; the router
# replicates; the shared experts' ``swi`` / ``swo`` go by column and row.
# MLA's ``wq_b`` / ``wkv_b`` go by whole heads (their columns are
# head-major) and its ``wo`` by row; the latent projections ``wq_a`` /
# ``wkv_a`` and their norms replicate (the reference shards ``wq_a`` and
# ``wkv_a`` by column too, but a normed latent cannot be split without a
# partitioner: each rank would need the whole latent's norm).


@dataclasses.dataclass(frozen=True)
class TrainPlan(TPPlan):
    """The training layout's plan: ``TPPlan``'s flags (``moe`` now the
    intra-expert fallback only) and the two that serving has no use for."""
    ep: bool         # routed experts whole over model (E % tp == 0)
    mla: bool        # MLA wq_b / wkv_b by head, wo by row


def train_plan_for(cfg, tp: int) -> TrainPlan:
    """Which weight families the training layout slices at ``tp``."""
    base = plan_for(cfg, tp)
    moe = cfg.moe
    ep = tp > 1 and moe is not None and moe.n_experts % tp == 0
    return TrainPlan(**dict(base.asdict(), moe=base.moe and not ep), ep=ep,
                     mla=(tp > 1 and cfg.mla is not None
                          and cfg.mla.n_heads % tp == 0))


def check_trainable(cfg) -> None:
    """Model-parallel training covers the attention and MLA decoders, with
    dense or MoE FFNs: raise for the other families."""
    fam = (sorted(k.upper() for k in set(cfg.pattern) - {"attn", "mla"})
           + (["encoder-decoder"] if cfg.enc_dec else []))
    if fam:
        raise ValueError(
            f"{cfg.name}: {'/'.join(fam)} model-parallel training waits for "
            f"ROADMAP Queue 1 item 11 (this slice trains the attention and "
            f"MLA decoders, dense and MoE)")


def train_slice(plan: TrainPlan, names: list[str]):
    """(axis, glu_permute) along which the training layout slices the leaf
    at path ``names`` over the model axis, or None (replicated)."""
    key = names[-1] if names else ""
    if "attn" in names and key in ("wq", "wk", "wv"):
        return (1, False) if plan.attn else None
    if "attn" in names and key == "wo":
        return (0, False) if plan.attn else None
    if "mlp" in names and key == "wi":
        return (1, True) if plan.ffn else None
    if "mlp" in names and key == "wo":
        return (0, False) if plan.ffn else None
    if "moe" in names and key in ("wi", "wo"):     # (E, d, 2f), (E, f, d)
        if plan.ep:
            return (0, False)
        if plan.moe:
            return (2, True) if key == "wi" else (1, False)
        return None
    if "moe" in names and key == "swi":
        return (1, True) if plan.shared else None
    if "moe" in names and key == "swo":
        return (0, False) if plan.shared else None
    if "mla" in names and key in ("wq_b", "wkv_b"):
        return (1, False) if plan.mla else None
    if "mla" in names and key == "wo":
        return (0, False) if plan.mla else None
    if key == "lm_head":
        return (1, False) if plan.lm_head else None
    return None       # embed, norms, router, MLA latents: replicated


def slice_leaf(t: torch.Tensor, axis: int, rank: int, tp: int,
               permute: bool) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``axis`` (the gate|up
    interleave first for a fused glu ``wi``)."""
    n = t.shape[axis]
    cols = _columns(n, rank, tp, permute)
    idx = torch.from_numpy(cols).to(t.device)
    return t.index_select(axis, idx).contiguous()


def unslice_leaf(parts: list, axis: int, permute: bool) -> torch.Tensor:
    """The full leaf from every rank's slice (``slice_leaf``'s inverse)."""
    full = torch.cat(parts, dim=axis)
    if not permute:
        return full
    inv = np.argsort(_glu_perm(full.shape[axis], len(parts)))
    return full.index_select(axis, torch.from_numpy(inv).to(full.device))


def prepare_train_params(cfg, params: dict, rank: int, tp: int) -> dict:
    """This rank's param tree for model-parallel training (``rank`` its
    coordinate on the model axis): every leaf ``train_slice`` names cut to
    the rank's share, the rest the caller's tensor.  The dense decoders
    carry no biases; ``q_norm`` / ``k_norm`` act per head with one (hd,)
    scale, so they replicate (``copy_to_model`` sums their gradients)."""
    check_trainable(cfg)
    plan = train_plan_for(cfg, tp)
    glu = cfg.ffn_kind() != "gelu"

    def cut(names, leaf):
        how = train_slice(plan, names)
        if how is None or tp == 1:
            return leaf
        axis, permute = how
        return slice_leaf(leaf, axis, rank, tp, permute and glu)
    return _walk_leaves(params, [], cut)


def model_sliced(a: torch.Tensor, full: int, axis: int = -1) -> bool:
    """Whether a plain weight holds a slice of its ``full`` width along
    ``axis`` (a quantized one never does in training)."""
    return isinstance(a, torch.Tensor) and a.shape[axis] < full


# ------------------------------------------------ training collectives


def _group_of(x: torch.Tensor) -> TPGroup:
    """The scope's group, for a collective on the sliced tensor ``x``."""
    group = _GROUP.get()
    if group is None or group.size == 1:
        raise RuntimeError(f"a sliced tensor {tuple(x.shape)} reached a "
                           f"model-parallel collective outside a group")
    return group


def _dry(group: TPGroup, x: torch.Tensor, kind: str, shape,
         nbytes: int) -> torch.Tensor:
    from repro_torch import kernels
    if not kernels.is_fake(x):
        raise RuntimeError("a dry-run group's collectives take fake "
                           "tensors only")
    kernels.collective(kind, nbytes, group.axis)
    return x.new_empty(shape)


def _dist_fn(new: str, old: str):
    """A ``torch.distributed`` function by its current name, or by the name
    older releases give it."""
    import torch.distributed as dist
    return getattr(dist, new, None) or getattr(dist, old)


def all_reduce(x: torch.Tensor, group: TPGroup, op: str = "sum"
               ) -> torch.Tensor:
    """A new tensor: ``x`` reduced (``op`` "sum" or "max") over ``group``'s
    ranks; ``x`` itself for a group of one.  Under gloo a CUDA tensor goes
    through the host."""
    if group.size == 1:
        return x
    nbytes = x.numel() * x.element_size()
    if group.backend == DRYRUN:
        return _dry(group, x, "all-reduce", x.shape, nbytes)
    import torch.distributed as dist
    from repro_torch import kernels
    kernels.collective("all-reduce", nbytes, group.axis)
    host = through_host(group, x)
    y = x.detach().to("cpu") if host else x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group.pg)
    return y.to(x.device) if host else y


def all_gather_flat(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """(n,) on each rank -> (size * n,): the ranks' ``x`` in rank order."""
    out_shape = (group.size * x.numel(),)
    nbytes = group.size * x.numel() * x.element_size()
    if group.size == 1:
        return x.reshape(-1)
    if group.backend == DRYRUN:
        return _dry(group, x, "all-gather", out_shape, nbytes)
    from repro_torch import kernels
    kernels.collective("all-gather", nbytes, group.axis)
    host = through_host(group, x)
    send = x.detach().reshape(-1)
    send = send.to("cpu") if host else send.contiguous()
    out = send.new_empty(out_shape)
    _dist_fn("all_gather_single", "all_gather_into_tensor")(
        out, send, group=group.pg)
    return out.to(x.device) if host else out


def gather_flat_to_root(x: torch.Tensor, group: TPGroup):
    """(n,) on each rank -> (size * n,) on the group's rank 0, the ranks'
    ``x`` in rank order; None on the others."""
    if group.size == 1:
        return x.reshape(-1)
    import torch.distributed as dist
    from repro_torch import kernels
    nbytes = group.size * x.numel() * x.element_size()
    kernels.collective("gather", nbytes, group.axis)
    host = through_host(group, x)
    send = x.detach().reshape(-1)
    send = send.to("cpu") if host else send.contiguous()
    parts = ([torch.empty_like(send) for _ in range(group.size)]
             if group.rank == 0 else None)
    dist.gather(send, gather_list=parts,
                dst=dist.get_global_rank(group.pg, 0), group=group.pg)
    if parts is None:
        return None
    out = torch.cat(parts)
    return out.to(x.device) if host else out


def reduce_scatter_flat(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """(size * n,) on each rank -> (n,): rank r's part of the sum over the
    ranks."""
    n = x.numel() // group.size
    if group.size == 1:
        return x.reshape(-1)
    nbytes = x.numel() * x.element_size()
    if group.backend == DRYRUN:
        return _dry(group, x, "reduce-scatter", (n,), nbytes)
    import torch.distributed as dist
    from repro_torch import kernels
    kernels.collective("reduce-scatter", nbytes, group.axis)
    host = through_host(group, x)
    send = x.detach().reshape(-1)
    send = send.to("cpu") if host else send.contiguous()
    out = send.new_empty((n,))
    _dist_fn("reduce_scatter_single", "reduce_scatter_tensor")(
        out, send, op=dist.ReduceOp.SUM, group=group.pg)
    return out.to(x.device) if host else out


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce over the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over the model group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """In front of a column-sliced linear (or a replicated scale applied to
    sliced heads): each rank's gradient of ``x`` covers its own columns,
    so the backward sums them over the scope's model group."""
    return _CopyToModel.apply(x, _group_of(x))


def reduce_from_model(y: torch.Tensor) -> torch.Tensor:
    """After a row-sliced linear: the ranks' partial sums added up."""
    return _ReduceFromModel.apply(y, _group_of(y))


class _VocabParallelNLL(torch.autograd.Function):
    """Per-token NLL over vocab-sliced logits: the max and the sum of
    exponentials all-reduced over the model group, the target's logit from
    the rank that holds it; the backward is softmax - onehot on each
    rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        lf = logits.to(torch.float32)
        v = lf.shape[-1]
        m = all_reduce(torch.amax(lf, dim=-1), group, "max")
        e = torch.exp(lf - m[..., None])
        se = all_reduce(torch.sum(e, dim=-1), group)
        local = labels.to(torch.int64) - group.rank * v
        inside = (local >= 0) & (local < v)
        idx = torch.where(inside, local, torch.zeros_like(local))
        tl = torch.gather(lf, -1, idx[..., None])[..., 0]
        tl = all_reduce(torch.where(inside, tl, torch.zeros_like(tl)), group)
        nll = torch.log(se) + m - tl
        e.div_(se[..., None])
        ctx.save_for_backward(e, idx, inside)
        ctx.dtype = logits.dtype
        return nll

    @staticmethod
    def backward(ctx, g):
        p, idx, inside = ctx.saved_tensors
        grad = p * g[..., None]
        hit = torch.where(inside, g, torch.zeros_like(g))
        grad.scatter_add_(-1, idx[..., None], -hit[..., None])
        return grad.to(ctx.dtype), None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor
                       ) -> torch.Tensor:
    """(..., V/tp) logits of this rank's vocab slice -> the full
    vocabulary's per-token NLL (...), f32, the same on every rank."""
    return _VocabParallelNLL.apply(logits, labels, _group_of(logits))

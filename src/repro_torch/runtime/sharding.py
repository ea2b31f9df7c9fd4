"""GSPMD-style sharding rules (port of ``repro/runtime/sharding.py``,
DESIGN.md §5), as the dry-run's yardstick of bytes per chip.

Axes: (pod?, data, model).  Batch shards over every data-parallel axis
("pod" + "data"); weights shard FSDP (ZeRO-3) over "data" and tensor-
parallel over "model" for training, over "model" only for serving; MoE
experts shard over "model" when it divides their count (expert
parallelism), else intra-expert TP; KV caches shard batch over dp and
sequence over "model".  Every rule goes through ``_fit``, which drops an
axis that does not divide its dimension, so rules degrade to replication.

A spec is a tuple with one entry per dimension: None, an axis name, or a
tuple of axis names, as a ``PartitionSpec``'s entries are.  ``mesh`` is
anything with ``axis_names`` and a ``shape`` mapping
(``launch/mesh.make_production_mesh``).

The reference's layer leaves are stacked (L_j, ...) for its scan, one
stack per scan position j; the port's ``layers`` is a list of per-layer
dicts.  So each rule runs on the stacked shape (n_j, *shape) that the
leaf would have in the reference, and its first entry is dropped: the
decisions that read the whole stack (the expert-parallel residue of
``_param_rule``) come out as the reference's.  Caches are per layer too
and are ruled the same way.  The port's serving runtime (``runtime/
tp.py``) shards by output column and replicates ``wo``; these rules are
what the reference's GSPMD program would hold per chip, and the dry-run
records both.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch


def dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def _entry(ax):
    """A spec entry as a ``PartitionSpec`` keeps it: one axis by its name,
    several as a tuple, none as None."""
    if isinstance(ax, tuple):
        return None if not ax else ax[0] if len(ax) == 1 else ax
    return ax


def _fit(spec: tuple, shape, mesh) -> tuple:
    """Drop spec entries that don't divide the corresponding dim."""
    out = []
    for i, dim in enumerate(shape):
        ax = _entry(spec[i]) if i < len(spec) else None
        if ax is not None and dim % _axis_size(mesh, ax) != 0:
            ax = None
        out.append(ax)
    return tuple(out)


# weight keys whose 2-D layout is (d_in, d_out) -> FSDP d_in, TP d_out
_COL_KEYS = {"wq", "wk", "wv", "wi", "swi", "wg", "wr", "ck", "cr",
             "wq_a", "wq_b", "wkv_a", "wkv_b", "embed"}
# (d_hidden, d_model) down-projections -> TP d_in, FSDP d_out
_ROW_KEYS = {"wo", "swo", "cv", "lm_head"}

# serve-mode EP weights also shard their inner dim over "data" when the
# per-chip residue after model-axis EP exceeds this (the reference's)
SERVE_EP_INNER_SHARD_LIMIT = 8 * 2 ** 30

_QUANT_REPLICATED = ("signs1", "signs2", "mean_col", "w_out", "out_idx",
                     "keep_idx")


def _param_rule(key: str, shape, mesh, names, serve: bool) -> tuple:
    fsdp = None if serve else "data"
    nd = len(shape)
    if "moe" in names and key in ("wi", "wo") and nd in (3, 4):
        # stacked (L, E, a, b) expert weights
        lead = (None,) * (nd - 3)
        e = shape[nd - 3]
        if e % mesh.shape["model"] == 0:
            per_chip = 2 * np.prod(shape) / mesh.shape["model"]
            inner = ("data" if not serve
                     or per_chip > SERVE_EP_INNER_SHARD_LIMIT else None)
            return _fit((*lead, "model", None, inner), shape, mesh)
        return _fit((*lead, None, "data" if not serve else None, "model"),
                    shape, mesh)
    if key == "router":
        return (None,) * nd
    if key in _COL_KEYS and nd >= 2:
        return _fit(((None,) * (nd - 2)) + (fsdp, "model"), shape, mesh)
    if key in _ROW_KEYS and nd >= 2:
        return _fit(((None,) * (nd - 2)) + ("model", fsdp), shape, mesh)
    return (None,) * nd  # norms, biases, LoRAs, convs: replicated


def _leaf_rule(names: list, shape, mesh, serve: bool) -> tuple:
    """The reference's ``param_specs`` rule for a leaf at path ``names``
    of (stacked) shape ``shape``."""
    key = names[-1] if names else ""
    nd = len(shape)
    if "packed" in names or "rescale" in names:
        if nd >= 2:
            if names[-1] == "rescale":
                return _fit(((None,) * (nd - 1)) + ("model",), shape, mesh)
            return _fit(((None,) * (nd - 2)) + (None, "model"), shape, mesh)
        return (None,) * nd
    if any(n in _QUANT_REPLICATED for n in names):
        return (None,) * nd
    return _param_rule(key, shape, mesh, names, serve)


def _walk(node, names: list, fn):
    """``node``'s tree with each tensor replaced by ``fn(names, tensor)``:
    dicts and lists keep their layout, a dataclass (a quantized weight, a
    cache) becomes a dict of its tensor fields, anything else None.  List
    positions add "" to the path, as the reference's sequence keys name
    nothing."""
    if isinstance(node, torch.Tensor):
        return fn(names, node)
    if isinstance(node, dict):
        return {k: _walk(v, names + [str(k)], fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_walk(v, names + [""], fn) for v in node]
    if dataclasses.is_dataclass(node):
        return {f.name: _walk(getattr(node, f.name), names + [f.name], fn)
                for f in dataclasses.fields(node)
                if isinstance(getattr(node, f.name), torch.Tensor)}
    return None


_LAYER_KEYS = ("layers", "enc_layers")


def _stack_size(n_layers: int, i: int, period: int) -> int:
    """Layers at layer i's scan position: the reference's stack length."""
    return len(range(i % period, n_layers, period))


def param_specs(params: dict, mesh, serve: bool = False, *,
                period: int = 1) -> dict:
    """Spec tree for a (possibly quantized) port param tree.  ``period``
    is the config's ``scan_period`` (the reference stacks ``layers`` by
    scan position; Whisper's ``enc_layers`` is one stack)."""
    def rule(names, t):
        return _leaf_rule(names, tuple(t.shape), mesh, serve)

    out = {}
    for key, node in params.items():
        if key in _LAYER_KEYS and isinstance(node, list):
            p = period if key == "layers" else 1
            layers = []
            for i, lp in enumerate(node):
                n_j = _stack_size(len(node), i, p)
                layers.append(_walk(lp, [key, ""], lambda names, t, n_j=n_j:
                                    _leaf_rule(names, (n_j, *t.shape), mesh,
                                               serve)[1:]))
            out[key] = layers
        else:
            out[key] = _walk(node, [key], rule)
    return out


def batch_specs(batch: dict, mesh) -> dict:
    dp = dp_axes(mesh)

    def rule(names, t):
        key = names[-1]
        shape = tuple(t.shape)
        if key == "positions" and len(shape) == 3:      # (3, B, S)
            return _fit((None, dp, None), shape, mesh)
        if key == "pos" or len(shape) == 0:
            return ()
        return _fit((dp,) + (None,) * (len(shape) - 1), shape, mesh)
    return {k: _walk(v, [k], rule) for k, v in batch.items()}


def _cache_rule(shape, mesh) -> tuple:
    """The reference's rule on a stacked (n_j, B, S?, ...) cache leaf."""
    nd = len(shape)
    if nd <= 1:
        return (None,) * nd
    spec = [None, dp_axes(mesh)] + [None] * (nd - 2)
    if nd >= 4:
        spec[2] = "model"                 # sequence / capacity axis
    return _fit(tuple(spec), shape, mesh)


def cache_specs(caches: list, mesh) -> list:
    """Per-layer cache specs: batch over dp, the sequence (or capacity)
    axis over model, ruled on the reference's stacked shape."""
    return _walk(caches, [], lambda names, t: _cache_rule(
        (1, *t.shape), mesh)[1:])


def replicate_specs(tree: Any):
    return _walk(tree, [], lambda names, t: (None,) * t.ndim)


def shard_factor(spec: tuple, mesh) -> int:
    """How many ways a leaf with ``spec`` is split across the mesh."""
    return int(np.prod([_axis_size(mesh, ax) for ax in spec]))


def bytes_per_chip(tree, specs, mesh) -> int:
    """Bytes of ``tree``'s tensors one chip holds under ``specs`` (a spec
    tree from the rules above, the same layout)."""
    total = 0

    def add(node, spec):
        nonlocal total
        if isinstance(node, torch.Tensor):
            total += (node.numel() * node.element_size()
                      // shard_factor(spec, mesh))
        elif isinstance(node, dict):
            for k, v in node.items():
                add(v, spec[k])
        elif isinstance(node, (list, tuple)):
            for v, s in zip(node, spec):
                add(v, s)
        elif dataclasses.is_dataclass(node):
            for k, s in spec.items():
                add(getattr(node, k), s)
    add(tree, specs)
    return total


# ------------------------------------------------------ ZeRO-3 execution
#
# The rules above say what a chip holds; what follows runs it.  A training
# rank at coordinates (d, m) of a (data dp, model tp) mesh holds its TP
# slice of every leaf (``runtime/tp.prepare_train_params``) cut again over
# the data axis: each leaf flattened, zero-padded to a multiple of dp and
# split into dp equal shards, of which it keeps shard d.  The optimizer's
# moments live on the same shards (``adamw_update`` is elementwise).  A
# unit (the embedding, each decoder layer, the final norm, ``lm_head``) is
# all-gathered over the data group where the forward uses it
# (``gathered``): a layer inside its ``torch.utils.checkpoint`` region, so
# the backward gathers it again and a rank holds one layer's full weights
# at a time, beside the embedding and the head.  The gather's backward
# reduce-scatters the full gradients into the rank's shards, their mean
# over dp.  The root units (the embedding, the final norm, ``lm_head``)
# are gathered once a step and their gradients summed over the
# microbatches before one reduce-scatter (``gather_roots`` /
# ``scatter_roots``): at a 152k vocabulary they are most of the bytes, and
# the rank holds them whole anyway.


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """One rank's view of a (data ``dp``, model ``tp``) training mesh, laid
    out in the reference's axis order: rank = d * tp + m.  ``model``
    spans the tp ranks of data row d (rank m), ``data`` the dp ranks of
    model column m (rank d); ``ctrl`` is a gloo group over every rank (the
    checkpoint's barrier, the fault loop's agreement).  ``launch/mesh.
    make_train_mesh`` builds it."""
    dp: int
    tp: int
    data: Any                # runtime.tp.TPGroup, axis "data"
    model: Any               # runtime.tp.TPGroup, axis "model"
    ctrl: Any = None

    @property
    def rank(self) -> int:
        return self.data.rank * self.tp + self.model.rank

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def device(self) -> torch.device:
        return self.model.device

    def barrier(self) -> None:
        if self.ctrl is not None:
            import torch.distributed as dist
            dist.barrier(group=self.ctrl)

    def agree(self, flag: bool) -> bool:
        """Whether ``flag`` holds on any rank (every rank calls it)."""
        if self.ctrl is None:
            return flag
        import torch.distributed as dist
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.ctrl)
        return bool(t.item())


def single_mesh(device) -> TrainMesh:
    """The 1 x 1 mesh: one rank, no collective."""
    from repro_torch.runtime.tp import TPGroup
    dev = torch.device(device)
    return TrainMesh(dp=1, tp=1,
                     data=TPGroup(rank=0, size=1, backend=None, device=dev,
                                  axis="data"),
                     model=TPGroup(rank=0, size=1, backend=None, device=dev))


def dryrun_mesh(dp: int, tp: int, device) -> TrainMesh:
    """Rank 0 of a (dp, tp) mesh that joins no process: its collectives
    take fake tensors and report their bytes under their axis."""
    from repro_torch.runtime.tp import dryrun_group
    return TrainMesh(dp=dp, tp=tp, data=dryrun_group(dp, device, "data"),
                     model=dryrun_group(tp, device, "model"))


@dataclasses.dataclass(frozen=True)
class _Unit:
    """The leaves of one ZeRO unit: its structure, each leaf's local (TP
    slice) shape, numel and shard length, and the leaves grouped by dtype
    (one collective per group)."""
    treedef: Any
    shapes: tuple
    numels: tuple
    shard_lens: tuple
    buckets: tuple           # ((leaf indices of one dtype), ...)


def _unit_of(tree, dp: int) -> _Unit:
    from repro_torch.tree import flatten
    flat, treedef = flatten(tree)
    numels = tuple(int(t.numel()) for t in flat)
    by_dtype: dict = {}
    for i, t in enumerate(flat):
        by_dtype.setdefault(t.dtype, []).append(i)
    return _Unit(treedef=treedef, shapes=tuple(tuple(t.shape) for t in flat),
                 numels=numels,
                 shard_lens=tuple(-(-n // dp) for n in numels),
                 buckets=tuple(tuple(v) for v in by_dtype.values()))


def _gather_leaves(unit: _Unit, group, shards) -> list:
    """A unit's shards -> its full (TP-slice) leaves, all-gathered over the
    data group, one collective per dtype.  Where the collective runs on a
    host copy (gloo), the leaves are cut from it there, so the card holds
    each one once."""
    from repro_torch.runtime.tp import all_gather_flat, through_host
    outs = [None] * len(shards)
    for idx in unit.buckets:
        total = sum(unit.shard_lens[i] for i in idx)
        flat = torch.cat([shards[i].reshape(-1) for i in idx])
        dev = flat.device
        if group.size > 1 and through_host(group, flat):
            flat = flat.cpu()
        g = all_gather_flat(flat, group).view(group.size, total)
        del flat
        off = 0
        for i in idx:
            s = unit.shard_lens[i]
            outs[i] = (g[:, off:off + s].reshape(-1)[:unit.numels[i]]
                       .reshape(unit.shapes[i]).to(dev, copy=True))
            off += s
    return outs


def _scatter_grads(unit: _Unit, group, grads) -> list:
    """A unit's full gradients -> the rank's shards of their mean over the
    data group (a reduce-scatter per dtype, divided by dp).  Where the
    collective runs on a host copy (gloo), its buffer is built there."""
    from repro_torch.runtime.tp import reduce_scatter_flat, through_host
    dp = group.size
    out = [None] * len(grads)
    for idx in unit.buckets:
        total = sum(unit.shard_lens[i] for i in idx)
        dev = grads[idx[0]].device
        host = dp > 1 and through_host(group, grads[idx[0]])
        buf = grads[idx[0]].new_zeros((dp, total),
                                      device="cpu" if host else dev)
        off = 0
        for i in idx:
            s, n = unit.shard_lens[i], unit.numels[i]
            flat = grads[i].reshape(-1)
            if dp * s != n:
                flat = torch.cat([flat, flat.new_zeros(dp * s - n)])
            buf[:, off:off + s] = flat.view(dp, s)
            off += s
        mine = reduce_scatter_flat(buf.view(-1), group)
        del buf
        if dp > 1:
            mine = mine.div_(dp)      # a new tensor: divide in place
        mine = mine.to(dev)
        off = 0
        for i in idx:
            s = unit.shard_lens[i]
            out[i] = mine[off:off + s]
            off += s
    return out


class _ZeroGather(torch.autograd.Function):
    """``_gather_leaves`` forward; ``_scatter_grads`` backward (autograd
    materializes the gradient of an unused output)."""

    @staticmethod
    def forward(ctx, unit: _Unit, group, *shards):
        ctx.unit, ctx.group = unit, group
        return tuple(_gather_leaves(unit, group, shards))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_scatter_grads(ctx.unit, ctx.group, grads))


class ZeroUnit:
    """A unit's shards in a forward's param tree: ``gathered`` turns it
    into the unit's full (TP-slice) leaves through ``_ZeroGather``."""

    def __init__(self, unit: _Unit, shards, group):
        self.unit, self.shards, self.group = unit, shards, group

    def full(self):
        from repro_torch.tree import flatten, unflatten
        leaves = flatten(self.shards)[0]
        return unflatten(self.unit.treedef,
                         list(_ZeroGather.apply(self.unit, self.group,
                                                *leaves)))


def gathered(node):
    """``node`` itself, or a ``ZeroUnit``'s full leaves (the models call it
    where they use a unit, so a single device's tree passes unchanged)."""
    return node.full() if isinstance(node, ZeroUnit) else node


def _leaf_paths(node, names=()):
    """Each leaf's path of keys, in ``repro_torch.tree.flatten``'s order."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaf_paths(node[k], names + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaf_paths(v, names + (str(i),))
    else:
        yield list(names)


def _units(tree: dict) -> list:
    """(key, index or None) of each ZeRO unit of a param tree."""
    out = []
    for k, v in tree.items():
        if isinstance(v, list):
            out.extend((k, i) for i in range(len(v)))
        else:
            out.append((k, None))
    return out


def _at(tree, key):
    k, i = key
    return tree[k] if i is None else tree[k][i]


class TrainLayout:
    """How a (dp, tp) mesh holds a decoder's params on one rank: the TP
    slice of each leaf (``runtime/tp.train_slice``) and its ZeRO shard
    over the data axis.  Built from ``cfg``'s shapes alone (meta tensors).
    A layer's unit holds the rank's slices only, so an expert-parallel
    layer gathers its E / tp experts, never the whole layer's.

      * ``shard(full)``: the rank's tree (1-D shards in the full tree's
        structure) from a full one-device tree, no collective;
      * ``view(layers, roots)``: the tree the forward reads, each layer
        a ``ZeroUnit``, the root units whole;
      * ``gather(shards)``: the full one-device tree back (collectives over
        both axes; every rank gets it);
      * ``sq_total`` / ``amax_total``: the clip's global squared norm and
        the int8 scales over the ranks that hold each leaf."""

    def __init__(self, cfg, mesh: TrainMesh):
        from repro_torch.models import transformer as tf
        from repro_torch.runtime import tp as tpmod
        from repro_torch.tree import flatten
        tpmod.check_trainable(cfg)
        self.cfg, self.mesh = cfg, mesh
        self.plan = tpmod.train_plan_for(cfg, mesh.tp)
        full = tf.init_params(cfg, torch.Generator(), device="meta")
        local = tpmod.prepare_train_params(cfg, full, mesh.model.rank,
                                           mesh.tp)
        self.keys = _units(full)
        self.units = {key: _unit_of(_at(local, key), mesh.dp)
                      for key in self.keys}
        self.full_shapes = [tuple(t.shape) for t in flatten(full)[0]]
        glu = cfg.ffn_kind() != "gelu"

        def how(names):
            h = None if mesh.tp == 1 else tpmod.train_slice(self.plan, names)
            return None if h is None else (h[0], h[1] and glu)
        # (axis, permute) or None, per leaf in flatten order
        self.slices = [how(names) for names in _leaf_paths(full)]
        self.sliced = [s is not None for s in self.slices]

    # -- placing a one-device tree on the rank
    def shard(self, full: dict) -> dict:
        """The rank's shards of a full one-device tree (params or a
        moment), in its structure; pure slicing, no collective."""
        from repro_torch.runtime import tp as tpmod
        local = tpmod.prepare_train_params(self.cfg, full,
                                           self.mesh.model.rank, self.mesh.tp)
        dp, d = self.mesh.dp, self.mesh.data.rank

        def cut(t):
            n = t.numel()
            s = -(-n // dp)
            flat = t.reshape(-1)
            if s * dp != n:
                flat = torch.cat([flat, flat.new_zeros(s * dp - n)])
            return flat[d * s:(d + 1) * s].clone()
        from repro_torch.tree import tree_map
        return tree_map(cut, local)

    def view(self, layers: dict, roots: dict) -> dict:
        """The forward's tree: each layer a ``ZeroUnit`` of its shards
        (``layers``: the shard tree's layer lists), each root unit its full
        leaves from ``roots`` (``gather_roots``)."""
        out = {}
        for key in self.keys:
            k, i = key
            if i is None:
                out[k] = roots[key]
            else:
                out.setdefault(k, [None] * len(layers[k]))[i] = ZeroUnit(
                    self.units[key], layers[k][i], self.mesh.data)
        return out

    @property
    def roots(self) -> list:
        return [key for key in self.keys if key[1] is None]

    def gather_roots(self, shards: dict) -> dict:
        """The root units' full leaves (key -> subtree), no autograd."""
        from repro_torch.tree import flatten, unflatten
        out = {}
        for key in self.roots:
            unit = self.units[key]
            leaves = flatten(_at(shards, key))[0]
            out[key] = unflatten(unit.treedef, _gather_leaves(
                unit, self.mesh.data, [t.detach() for t in leaves]))
        return out

    def scatter_roots(self, grads: dict) -> dict:
        """The root units' full gradients -> the rank's shards of their
        mean over dp (key -> subtree)."""
        from repro_torch.tree import flatten, unflatten
        return {key: unflatten(self.units[key].treedef, _scatter_grads(
                    self.units[key], self.mesh.data,
                    flatten(grads[key])[0]))
                for key in self.roots}

    # -- the full tree back
    def gather(self, shards: dict):
        """The full one-device tree on global rank 0 from every rank's
        shards (gathers over the data group, then the model group of data
        row 0; no autograd); None on the other ranks."""
        from repro_torch.runtime import tp as tpmod
        from repro_torch.tree import flatten, unflatten
        flat, treedef = flatten(shards)
        out = []
        for t, full_shape, how in zip(flat, self.full_shapes, self.slices):
            g = tpmod.gather_flat_to_root(t.detach(), self.mesh.data)
            if g is None:
                continue
            local_shape = list(full_shape)
            if how is not None:
                local_shape[how[0]] //= self.mesh.tp
            n = int(np.prod(local_shape))
            leaf = g[:n].reshape(local_shape)
            if how is not None:
                parts = tpmod.gather_flat_to_root(leaf.contiguous(),
                                                  self.mesh.model)
                if parts is None:
                    continue
                parts = list(parts.view(self.mesh.tp, *local_shape))
                leaf = tpmod.unslice_leaf(parts, how[0], how[1])
            out.append(leaf.clone())
        return unflatten(treedef, out) if self.mesh.rank == 0 else None

    def shard_state(self, state):
        """(params, AdamWState) of one device -> the rank's."""
        from repro_torch.optim import AdamWState
        params, opt = state
        return (self.shard(params),
                AdamWState(step=opt.step, mu=self.shard(opt.mu),
                           nu=self.shard(opt.nu)))

    def gather_state(self, state):
        """The rank's (params, AdamWState) -> one device's on global rank
        0, None on the others."""
        from repro_torch.optim import AdamWState
        params, opt = state
        full = (self.gather(params), self.gather(opt.mu),
                self.gather(opt.nu))
        if self.mesh.rank:
            return None
        return full[0], AdamWState(step=opt.step, mu=full[1], nu=full[2])

    def full_like(self, shards: dict) -> dict:
        """Meta tensors of the full one-device tree, in the shards'
        dtypes (the ``like`` a checkpoint restores into)."""
        from repro_torch.tree import flatten, unflatten
        flat, treedef = flatten(shards)
        return unflatten(treedef, [
            torch.empty(shape, dtype=t.dtype, device="meta")
            for t, shape in zip(flat, self.full_shapes)])

    # -- reductions over the ranks that hold a leaf
    def sq_total(self, sq: list) -> torch.Tensor:
        """The global squared norm from each shard's squared norm (flatten
        order): summed over the data group, and over the model group for
        the sliced leaves only (an expert-parallel leaf's experts are
        disjoint over the model axis; a replicated leaf, the router too,
        counts once)."""
        from repro_torch.runtime.tp import all_reduce
        zero = sq[0].new_zeros(())
        sl = sum((q for q, s in zip(sq, self.sliced) if s), zero)
        rp = sum((q for q, s in zip(sq, self.sliced) if not s), zero)
        both = all_reduce(torch.stack([sl, rp]), self.mesh.data)
        sl = all_reduce(both[:1], self.mesh.model)[0]
        return sl + both[1]

    def amax_total(self, amax: torch.Tensor) -> torch.Tensor:
        """The int8 scale groups' largest |g| over every rank that holds a
        part of them: a MAX over the data group, then over the model group
        (a replicated group's parts are equal there)."""
        from repro_torch.runtime.tp import all_reduce
        amax = all_reduce(amax, self.mesh.data, "max")
        return all_reduce(amax, self.mesh.model, "max")

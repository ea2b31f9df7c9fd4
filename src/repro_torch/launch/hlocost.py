"""Op-level cost counter: flops, bytes and collective bytes of one step
(the port's analog of ``repro/launch/hlocost.py``).

The reference walks the optimized HLO of a compiled program, multiplying
each ``while`` body by its trip count, because XLA's own cost analysis
counts a loop body once.  PyTorch runs eagerly and has no HLO: here a
``TorchDispatchMode`` sees every ATen op a step dispatches, so a Python
loop counts once per trip by construction (``unknown_trip_whiles`` is
always 0).  The step runs on real tensors (the kernels launch, or their
plain versions run on the host) or on fake ones (``FakeTensorMode``:
shapes only, nothing allocated); the counts are the same either way.

  * flops — 2 M N K per matmul-family op (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, convolution, SDPA), by ``torch.utils.flop_counter``'s
    formulas: the work the reference's ``analyze_hlo`` counts per ``dot``;
  * bytes — the reference's kernel-IO model: each op reads its tensor
    operands and writes its result.  Views and aliases (``view``,
    ``_unsafe_view``, ``expand``, ``slice``, ``select``, ``t``,
    ``transpose``, ``detach``, ``as_strided``, ...) and ``empty`` count
    nothing (``_SKIP_BYTES`` in the reference); a gather reads the rows it
    returns and its indices; an in-place write (``index_put_``,
    ``index_copy_``, ``copy_``, a scatter) reads what it writes and its
    indices and writes the window, not the whole buffer;
  * kernels — a kernel wrapper's call is credited its kernel's own work
    (``repro_torch.kernels.credited``: the operations and compulsory bytes
    of its ``cost(...)``), and the ops it dispatches beneath are not
    counted;
  * collectives — the TP gathers of a dry-run group report the gathered
    result's bytes as ``all-gather`` (the reference counts max(operand,
    result) per collective: the result, for a gather).

A model loop whose trips all have one shape may run one trip on fake
inputs under ``repro_torch.kernels.repeated(trips)``, which counts it
``trips`` times (RWKV6's chunk loop: 2048 trips a layer at 32k tokens),
as the reference multiplies a ``while`` body by its trip count.

``memory``: the counter also tracks every storage the step allocates (its
bytes added when a non-view op makes it, subtracted when the last tensor
on it is freed), so ``temp_peak`` is the most the step held beyond its
arguments at once.

``CostCounter(trace=True)`` keeps each op's name, argument shapes and
dtypes, count and the kernel it was credited to; ``recount`` re-derives
the totals from such a trace under the current rules without re-running
the step (``launch/reanalyze.py``).
"""
from __future__ import annotations

import json
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels

aten = torch.ops.aten

# views and aliases: no bytes move (beyond ``OpOverload.is_view``)
_VIEWS = {"_unsafe_view", "detach", "alias", "lift_fresh", "t",
          "_reshape_alias", "unsqueeze", "squeeze", "view_as_real",
          "view_as_complex", "_conj", "_neg_view", "as_strided",
          "expand", "permute", "transpose", "slice", "select", "view",
          "reshape", "split", "split_with_sizes", "chunk", "unbind",
          "narrow", "diagonal", "unfold", "_local_scalar_dense"}
# allocate without writing
_EMPTY = {"empty", "empty_like", "new_empty", "empty_strided",
          "new_empty_strided", "resize_"}
# ops whose outputs past the first are scratch of a size that depends on
# the device (log_sigmoid's buffer is the input's size on the CPU, empty
# on CUDA): only the first output is counted and tracked
_FIRST_OUTPUT = {"log_sigmoid_forward"}
# gathers: the rows returned, read and written, and the indices
_GATHERS = {"index_select", "gather", "embedding", "take"}
# in-place window writes: read the update and the indices, write the window
_WINDOW_WRITES = {"index_put_", "index_put", "_index_put_impl_",
                  "index_copy_", "index_copy", "scatter_", "scatter",
                  "scatter_add_", "scatter_add", "index_add_", "index_add",
                  "masked_scatter_", "masked_scatter"}


def _spec(x):
    """A JSON-able stand-in for an op argument: a tensor's shape and dtype,
    a dtype or device by name, containers element by element."""
    if isinstance(x, torch.Tensor):
        return {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1]}
    if isinstance(x, (list, tuple)):
        return [_spec(v) for v in x]
    if isinstance(x, (bool, int, float, str)) or x is None:
        return x
    return repr(x)


_ITEMSIZE = {}


def _itemsize(dtype: str) -> int:
    if dtype not in _ITEMSIZE:
        _ITEMSIZE[dtype] = torch.empty((), dtype=getattr(torch, dtype)
                                       ).element_size()
    return _ITEMSIZE[dtype]


def _is_tspec(x) -> bool:
    return isinstance(x, dict) and "shape" in x and "dtype" in x


def _spec_bytes(x) -> int:
    n = 1
    for s in x["shape"]:
        n *= s
    return n * _itemsize(x["dtype"])


def _tensor_specs(args) -> list:
    out = []
    for a in args:
        if _is_tspec(a):
            out.append(a)
        elif isinstance(a, list):
            out.extend(_tensor_specs(a))
    return out


def op_bytes(op: str, args: list, outs: list) -> int:
    """Bytes one op moves under the kernel-IO model, from its argument and
    output specs (``_spec``).  ``op`` is ``<namespace>.<name>.<overload>``;
    only ATen ops move data (``prim.device`` and the like read metadata)."""
    if not op.startswith("aten."):
        return 0
    name = op.split(".")[1]
    if name in _VIEWS or name in _EMPTY:
        return 0
    ins = _tensor_specs(args)
    res = sum(_spec_bytes(o) for o in _tensor_specs(outs))
    if name in _GATHERS:
        idx = _spec_bytes(ins[1]) if len(ins) > 1 else 0
        return 2 * res + idx
    if name == "copy_":
        return 2 * _spec_bytes(ins[1]) if len(ins) > 1 else res
    if name in _WINDOW_WRITES:
        upd = _spec_bytes(ins[-1]) if len(ins) > 1 else 0
        idx = sum(_spec_bytes(i) for i in ins[1:-1])
        return 2 * upd + idx
    return res + sum(_spec_bytes(i) for i in ins)


def op_flops(op: str, args: list, kwargs: dict, outs: list) -> float:
    """Matmul-family flops from the op's argument and output specs, by
    ``torch.utils.flop_counter``'s formulas (0 for any other op)."""
    packet = getattr(aten, op.split(".")[1], None) if op.startswith(
        "aten.") else None
    fn = flop_registry.get(packet) if packet is not None else None
    if fn is None:
        return 0.0

    def shape(x):
        if _is_tspec(x):
            return torch.Size(x["shape"])
        if isinstance(x, list):
            return [shape(v) for v in x]
        return x
    out = [shape(o) for o in outs]
    return float(fn(*[shape(a) for a in args],
                    **{k: shape(v) for k, v in kwargs.items()},
                    out_val=out[0] if len(out) == 1 else tuple(out)))


class _Memory:
    """Live bytes of the storages a step allocates, and their peak."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._refs: dict[int, list] = {}     # storage key -> [bytes, refs]

    def _drop(self, key):
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._refs[key]

    def track(self, new: bool, outs) -> None:
        for t in outs:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._refs:
                if not new:
                    continue             # a view of an argument, or an alias
                self._refs[key] = [st.nbytes(), 0]
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
            self._refs[key][1] += 1
            weakref.finalize(t, self._drop, key)


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched inside it (see the module docstring).
    Totals: ``flops``, ``bytes``, ``coll_bytes``, ``coll_by_kind``,
    ``kernel_credits`` (kernel -> calls, flops, bytes), ``memory``."""

    def __init__(self, trace: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes = 0.0
        self.coll_by_kind: dict[str, float] = {}
        self.kernel_credits: dict[str, dict] = {}
        self.mem = _Memory()
        self._kernel: list[str] = []        # the credited call we are in
        self._trips = 1                     # product of enclosing repeats
        self._repeats: list[int] = []
        self._trace = {} if trace else None
        self._kernel_trace: dict = {} if trace else None

    # -- kernels and collectives (called by repro_torch.kernels) --
    def enter_kernel(self, kernel: str, shape: dict) -> None:
        if not self._kernel:
            n = self._trips
            c = kernels.kernel_cost(kernel, **shape)
            k = self.kernel_credits.setdefault(
                kernel, {"calls": 0, "flops": 0.0, "bytes": 0.0})
            k["calls"] += n
            k["flops"] += n * c["flops"]
            k["bytes"] += n * c["bytes"]
            self.flops += n * c["flops"]
            self.bytes += n * c["bytes"]
            if self._kernel_trace is not None:
                key = json.dumps([kernel, shape], sort_keys=True)
                self._kernel_trace[key] = self._kernel_trace.get(key, 0) + n
        self._kernel.append(kernel)

    def exit_kernel(self) -> None:
        self._kernel.pop()

    def enter_repeat(self, trips: int) -> None:
        self._repeats.append(trips)
        self._trips *= trips

    def exit_repeat(self) -> None:
        self._trips //= self._repeats.pop()

    def add_collective(self, kind: str, nbytes: int) -> None:
        n = self._trips
        self.coll_bytes += n * nbytes
        self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0) + n * nbytes
        if self._trace is not None:
            key = json.dumps(["collective", kind, nbytes])
            self._trace[key] = self._trace.get(key, 0) + n

    # -- the dispatch hook --
    def __enter__(self):
        kernels._SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels._SINKS.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = tree_flatten(out)[0]
        name = func.overloadpacket.__name__
        if name in _FIRST_OUTPUT:
            outs = outs[:1]
        self.mem.track(not (func.is_view or name in _VIEWS
                            or name.endswith("_")), outs)
        if self._kernel and self._trace is None:
            return out
        op = f"{func.namespace}.{name}.{func._overloadname}"
        a = _spec(list(args))
        kw = {k: _spec(v) for k, v in kwargs.items()}
        o = _spec(outs)
        if self._trace is not None:
            key = json.dumps([op, a, kw, o, self._kernel[0] if self._kernel
                              else None])
            self._trace[key] = self._trace.get(key, 0) + self._trips
        if not self._kernel:
            self.flops += self._trips * op_flops(op, a, kw, o)
            self.bytes += self._trips * op_bytes(op, a + list(kw.values()), o)
        return out

    # -- results --
    def totals(self) -> dict:
        return dict(flops=self.flops, bytes=self.bytes,
                    coll_bytes=self.coll_bytes,
                    coll_by_kind=dict(self.coll_by_kind),
                    unknown_trip_whiles=0,
                    kernel_credits={k: dict(v) for k, v in
                                    self.kernel_credits.items()})

    def ops_trace(self) -> dict:
        """The trace (``trace=True``): ops with their specs, counts and
        the kernel each was dispatched under; kernel credits with their
        shapes; collectives."""
        ops = []
        for key, n in self._trace.items():
            entry = json.loads(key)
            if entry[0] == "collective":
                ops.append({"collective": entry[1], "bytes": entry[2],
                            "count": n})
            else:
                ops.append({"op": entry[0], "args": entry[1],
                            "kwargs": entry[2], "out": entry[3],
                            "kernel": entry[4], "count": n})
        credits = [{"kernel": json.loads(k)[0], "shape": json.loads(k)[1],
                    "count": n} for k, n in self._kernel_trace.items()]
        return {"ops": ops, "kernel_calls": credits}


def recount(trace: dict) -> dict:
    """The totals of a saved trace (``CostCounter.ops_trace``) under the
    current rules: ops outside a kernel by their specs, kernel calls by
    their wrappers' ``cost``, collectives by their bytes."""
    t = {"flops": 0.0, "bytes": 0.0, "coll_bytes": 0.0, "coll_by_kind": {},
         "unknown_trip_whiles": 0, "kernel_credits": {}}
    for e in trace["ops"]:
        n = e["count"]
        if "collective" in e:
            t["coll_bytes"] += n * e["bytes"]
            t["coll_by_kind"][e["collective"]] = (
                t["coll_by_kind"].get(e["collective"], 0) + n * e["bytes"])
        elif e["kernel"] is None:
            t["flops"] += n * op_flops(e["op"], e["args"], e["kwargs"],
                                       e["out"])
            t["bytes"] += n * op_bytes(
                e["op"], e["args"] + list(e["kwargs"].values()), e["out"])
    for e in trace["kernel_calls"]:
        c = kernels.kernel_cost(e["kernel"], **e["shape"])
        k = t["kernel_credits"].setdefault(
            e["kernel"], {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += e["count"]
        k["flops"] += e["count"] * c["flops"]
        k["bytes"] += e["count"] * c["bytes"]
        t["flops"] += e["count"] * c["flops"]
        t["bytes"] += e["count"] * c["bytes"]
    return t


def analyze(fn, *args, trace: bool = False, **kw) -> dict:
    """Run ``fn(*args, **kw)`` under a ``CostCounter`` and return the
    reference's ``analyze_hlo`` keys (``flops``, ``bytes``,
    ``coll_bytes``, ``coll_by_kind``, ``unknown_trip_whiles``) with
    ``kernel_credits``, ``memory`` (``temp_peak``) and, with ``trace``,
    ``ops``.  Fake inputs need an enclosing ``FakeTensorMode``."""
    with CostCounter(trace=trace) as cc:
        out = fn(*args, **kw)
    res = cc.totals()
    res["memory"] = {"temp_peak": cc.mem.peak}
    if trace:
        res["ops"] = cc.ops_trace()
    res["result"] = out
    return res

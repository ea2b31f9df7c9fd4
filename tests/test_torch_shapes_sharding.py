"""The dry-run's shape cells and sharding rules in the port
(``repro_torch/configs/shapes.py``, ``runtime/sharding.py``,
``launch/mesh.make_production_mesh``) against the JAX reference
(``repro/configs/shapes.py``, ``repro/runtime/sharding.py``).

``SHAPES``, ``cell_applicable`` and ``input_specs`` equal the reference's
for every arch x shape.  ``param_specs``, ``batch_specs`` and
``cache_specs`` equal the reference's, as tuples, on
``jax.sharding.AbstractMesh`` meshes of (16, 16), (2, 16, 16), (32, 8) and
(2, 32, 8): the fp trees of every registry config at full width, in serve
and train mode; the reference's stacked (L_j, ...) leaf with its layer
axis dropped is each of the port's per-layer leaves at that scan
position.  deepseek-v2's expert-parallel decision (its 450 GB of experts
shard their inner dim over "data" in serve mode; Mixtral's do not) comes
out as the reference's.  The uniform 4-bit trees (the reference's by
``jax.eval_shape`` of its ``quantize_params_uniform``, the port's
shape-only under ``FakeTensorMode``) are compared on every arch's tiny
config (about 100 s of reference tracing at full width would take the
file past its budget) and on qwen3-0.6b at full width.  The caches of a
decode_32k cell at full width, and the batch of every cell.
"""
import functools

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core.pipeline import quantize_params_uniform as jq  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          get_tiny)
from repro_torch.core.pipeline import quantize_params_uniform  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import decode as tdec  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((32, 8), ("data", "model")),
          ((2, 32, 8), ("pod", "data", "model"))]
DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
          jnp.float32: torch.float32}


class _Mesh:
    """The port's view of a mesh: axis names and a shape mapping."""

    def __init__(self, sizes, names):
        self.axis_names, self.shape = names, dict(zip(names, sizes))


def _meshes():
    return [(jax.sharding.AbstractMesh(sizes, names), _Mesh(sizes, names))
            for sizes, names in MESHES]


def _cfgs(arch, tiny):
    return ((jreg.get_tiny if tiny else jreg.get_config)(arch),
            (get_tiny if tiny else get_config)(arch))


def _name(e):
    for attr in ("key", "name", "idx"):
        if hasattr(e, attr):
            return getattr(e, attr)
    return ""


def _ref_leaves(spec_tree):
    """path (names; list positions as ints) -> spec tuple."""
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]
    return {tuple(_name(e) for e in path): tuple(spec) for path, spec in flat}


def _port_leaves(tree, path=()):
    if isinstance(tree, tuple):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (i,))


def _match_layers(ref: dict, port_tree, period: int, stacked=("layers",
                                                              "enc_layers")):
    """Every port leaf against the reference's: a layer leaf (key, i,
    *rest) against the stacked (key, i % period, *rest) minus its layer
    axis, any other leaf as it is.  Every reference leaf is matched."""
    seen = set()
    n = 0
    for path, spec in _port_leaves(port_tree):
        if path and path[0] in stacked:
            p = period if path[0] == "layers" else 1
            key = (path[0], path[1] % p, *path[2:])
            want = ref[key][1:]
        else:
            key = path
            want = ref[key]
        assert spec == want, (path, spec, want)
        seen.add(key)
        n += 1
    assert seen == set(ref), set(ref) ^ seen
    return n


# ------------------------------------------------------------------ shapes


def test_shape_cells_equal_the_reference():
    assert {k: (c.name, c.kind, c.seq_len, c.global_batch)
            for k, c in tshapes.SHAPES.items()} == {
        k: (c.name, c.kind, c.seq_len, c.global_batch)
        for k, c in jshapes.SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_applicable_and_input_specs(arch):
    jcfg, tcfg = _cfgs(arch, False)
    for shape in tshapes.SHAPES:
        assert tshapes.cell_applicable(tcfg, shape) == \
            jshapes.cell_applicable(jcfg, shape)
        want = {k: (tuple(v.shape), DTYPES[v.dtype.type]) for k, v in
                jshapes.input_specs(jcfg, shape).items()}
        assert tshapes.input_specs(tcfg, shape) == want
        got = tshapes.input_specs(tcfg, shape, device="meta")
        assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == want
        conc = tshapes.concrete_inputs(tcfg, shape, batch=2)
        f32 = tshapes.input_specs(tcfg, shape, torch.float32, batch=2)
        assert {k: (tuple(v.shape), v.dtype) for k, v in conc.items()} == f32
        for k, v in conc.items():
            if k == "tokens":
                assert int(v.min()) >= 0 and int(v.max()) < tcfg.vocab


def test_production_mesh_is_the_h100_layout():
    for multi, sizes, name in ((False, (32, 8), "32x8"),
                               (True, (2, 32, 8), "2x32x8")):
        m = make_production_mesh(multi_pod=multi)
        assert m.sizes == sizes and m.name == name
        assert m.size == (512 if multi else 256)
        assert m.shape["model"] == 8          # one NVLink node
        assert shd.dp_axes(m) == (("pod", "data") if multi else ("data",))


# ------------------------------------------------------------------ params


@functools.lru_cache(maxsize=None)
def _ref_params(arch, tiny, quant):
    jcfg, _ = _cfgs(arch, tiny)

    def build():
        p = jtf.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
        return jq(jcfg, p, 4, jax.random.PRNGKey(1)) if quant else p
    return jax.eval_shape(build)


def _port_params(arch, tiny, quant):
    _, tcfg = _cfgs(arch, tiny)
    with FakeTensorMode(allow_non_fake_inputs=True):
        p = ttf.init_params(tcfg, device="cpu", dtype=torch.bfloat16)
        if quant:
            p = quantize_params_uniform(tcfg, p, 4, device="cpu")
    return p


def _check_params(arch, tiny, quant):
    jcfg, tcfg = _cfgs(arch, tiny)
    ref_tree = _ref_params(arch, tiny, quant)
    params = _port_params(arch, tiny, quant)
    n = 0
    for jmesh, tmesh in _meshes():
        for serve in (True, False):
            ref = _ref_leaves(jshd.param_specs(ref_tree, jmesh, serve=serve))
            got = shd.param_specs(params, tmesh, serve=serve,
                                  period=tcfg.scan_period)
            n += _match_layers(ref, got, tcfg.scan_period)
    return n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_fp_full_width(arch):
    assert _check_params(arch, False, False) > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_quantized_tiny(arch):
    assert _check_params(arch, True, True) > 0


def test_param_specs_quantized_full_width_qwen3():
    assert _check_params("qwen3-0.6b", False, True) > 0


def test_expert_parallel_decision_reads_the_whole_stack():
    """Serve mode: deepseek-v2's experts, 2 x 60 x (160, a, b) / 8 bytes
    a chip past the 8 GiB limit over the stack, also shard their inner
    dim over data; Mixtral's (32 layers of 8) do not.  Per layer neither
    would."""
    tmesh = _Mesh((32, 8), ("data", "model"))
    for arch, inner in (("deepseek-v2-236b", "data"), ("mixtral-8x7b", None)):
        params = _port_params(arch, False, False)
        got = shd.param_specs(params, tmesh, serve=True)
        assert got["layers"][0]["moe"]["wi"] == ("model", None, inner)
        assert got["layers"][-1]["moe"]["wo"] == ("model", None, inner)


# ------------------------------------------------------------ batch, caches


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs(arch):
    jcfg, tcfg = _cfgs(arch, False)
    for jmesh, tmesh in _meshes():
        for shape in tshapes.SHAPES:
            ref = _ref_leaves(jshd.batch_specs(
                jshapes.input_specs(jcfg, shape), jmesh))
            got = shd.batch_specs(tshapes.input_specs(tcfg, shape,
                                                      device="meta"), tmesh)
            assert dict(_port_leaves(got)) == ref
    cell = tshapes.SHAPES["decode_32k"]
    b = cell.global_batch
    enc = (jax.ShapeDtypeStruct((b, jcfg.n_audio_ctx, jcfg.d_model),
                                jnp.bfloat16) if jcfg.enc_dec else None)
    ref_caches = jax.eval_shape(
        lambda p, e: jdec.init_caches(jcfg, p, b, cell.seq_len, jnp.bfloat16,
                                      encoder_out=e),
        _ref_params(arch, False, False), enc)
    with FakeTensorMode():
        caches = tdec.init_caches(tcfg, b, cell.seq_len, torch.bfloat16,
                                  "cpu")
        if tcfg.enc_dec:
            for c in caches:
                for key in ("xk", "xv"):
                    c[key] = torch.empty((b, tcfg.n_audio_ctx, tcfg.n_kv,
                                          tcfg.hd))
    for jmesh, tmesh in _meshes():
        ref = _ref_leaves(jshd.cache_specs(ref_caches, jmesh))
        ref = {("layers",) + k: v for k, v in ref.items()}
        got = {"layers": shd.cache_specs(caches, tmesh)}
        assert _match_layers(ref, got, tcfg.scan_period) > 0
    rep = list(_port_leaves(shd.replicate_specs(caches)))
    assert rep and all(set(spec) <= {None} for _, spec in rep)

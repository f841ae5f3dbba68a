"""The port's sharding rules and specs, held against the reference's on
the CPU, in one process, with no ranks.

The reference's `ShardingContext` and `params_partition_specs` read only
a mesh's `shape` and `axis_names`, so a stand-in mesh drives them on any
shape; the port's run on an abstract `launch.mesh.Mesh` of the same
shape. The parameter trees are both packages' `init_lm` trees, shapes
only (`jax.eval_shape`; the port's on the `meta` device). `param_shardings`,
`cache_shardings` and `train_batch_specs` of the reference need a real
mesh, so a subprocess with 8 forced host devices runs them on
`AxisType.Auto` meshes (the axis type `with_sharding_constraint`
accepts) and prints its specs as JSON. Every comparison is exact.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.dist.sharding import TRAIN_RULES as J_TRAIN_RULES
from repro.dist.sharding import SERVE_RULES as J_SERVE_RULES
from repro.dist.sharding import ShardingContext as JShardingContext
from repro.dist.sharding import params_partition_specs as j_partition_specs
from repro.dist.sharding import sharding_rules as j_sharding_rules
from repro.models import init_lm as j_init_lm
from repro.quant.bitplane import PimQuantConfig as JPimQuantConfig
from repro.quant.bitplane import quantize_tree as j_quantize_tree
from repro_torch.bridge import spec_from_jax, specs_from_jax
from repro_torch.configs import SHAPES, get_config
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (
    SERVE_RULES,
    TRAIN_RULES,
    ShardingContext,
    params_partition_specs,
    sharding_rules,
)
from repro_torch.launch import specs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import init_lm
from repro_torch.quant.bitplane import PimQuantConfig, PimWeight, quantize_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = [
    ((1, 1), ("data", "model")),
    ((2, 4), ("data", "model")),
    ((1, 8), ("data", "model")),
    ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")),
]


class StandIn:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, axis_names):
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = tuple(axis_names)


def _flat(tree, path=""):
    """{path: spec} of a spec tree, a `PimWeight`'s planes and scale as
    `<name>/planes` and `<name>/scale`."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    if isinstance(tree, PimWeight):
        return {f"{path}/planes": tree.planes, f"{path}/scale": tree.scale}
    return {path: tree}


_TREES = {}


def _trees(arch, quantized):
    """(reference shapes, port meta tree) of an `ARCH_IDS` smoke config,
    quantized by `PimQuantConfig(8, 1, "ref", min_features=1)`."""
    key = (arch, quantized)
    if key not in _TREES:
        jcfg = j_get_config(arch, smoke=True)
        cfg = get_config(arch, smoke=True)

        def j_init():
            p = j_init_lm(jax.random.PRNGKey(0), jcfg)
            if quantized:
                p = j_quantize_tree(p, JPimQuantConfig(
                    n_bits=8, group=1, impl="ref", min_features=1))
            return p

        p = init_lm(cfg, torch.Generator(), "meta", param_dtype=torch.float32)
        if quantized:
            p = quantize_tree(p, PimQuantConfig(n_bits=8, group=1, impl="ref",
                                                min_features=1))
        _TREES[key] = (jax.eval_shape(j_init), p)
    return _TREES[key]


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in _flat(tree).items()}


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "pim8"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partition_specs_equal_reference(arch, quantized):
    """The whole spec tree, leaf for leaf, on all five meshes."""
    j_tree, tree = _trees(arch, quantized)
    assert _shapes(tree) == {k: tuple(v.shape) for k, v in _flat(
        _jax_pims(j_tree)).items()}
    for shape, axes in MESHES:
        with j_sharding_rules(StandIn(shape, axes)):
            want = _flat(specs_from_jax(_jax_pims(
                j_partition_specs(j_tree))))
        with sharding_rules(Mesh(shape, axes)):
            got = _flat(params_partition_specs(tree))
        assert got == want, (arch, quantized, shape)


def _jax_pims(tree):
    """The reference's tree with its `PimWeight`s as the port's (same
    fields), so one flattening walks both."""
    if isinstance(tree, dict):
        return {k: _jax_pims(v) for k, v in tree.items()}
    if hasattr(tree, "planes") and hasattr(tree, "n_bits"):
        return PimWeight(tree.planes, tree.scale, tree.n_bits, tree.group)
    return tree


NAMES = [None, "batch", "seq", "embed", "heads", "kv_heads", "head_dim",
         "ff", "vocab", "layers", "kv_seq", "cache_head_dim"]


@pytest.mark.parametrize("rules", ["train", "serve"])
@pytest.mark.parametrize("mesh", MESHES,
                         ids=["x".join(map(str, m[0])) for m in MESHES])
def test_resolve_equals_reference(mesh, rules):
    """`resolve` over a grid of logical names x shapes, divisibility and
    single use included (batch 1 frees `data` for kv_seq under the
    serving rules; a dimension the axes do not divide stays whole)."""
    shape, axes = mesh
    j_rules, p_rules = ((J_TRAIN_RULES, TRAIN_RULES) if rules == "train"
                        else (J_SERVE_RULES, SERVE_RULES))
    assert dict(j_rules) == dict(p_rules)
    jctx = JShardingContext(StandIn(shape, axes), j_rules)
    ctx = ShardingContext(Mesh(shape, axes), p_rules)
    rng = np.random.default_rng(0)
    dims = [1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 256, 512, 1536]
    cases = [("layers", "batch", "kv_seq", "kv_heads", "cache_head_dim"),
             ("batch", "seq", "heads", "head_dim"),
             ("batch", "seq", "vocab"), ("batch", "seq", "ff")]
    for _ in range(300):
        n = int(rng.integers(1, 6))
        cases.append(tuple(NAMES[i] for i in rng.integers(0, len(NAMES), n)))
    for names in cases:
        for _ in range(4):
            shp = tuple(int(d) for d in rng.choice(dims, len(names)))
            want = spec_from_jax(jctx.resolve(*names, shape=shp))
            assert ctx.resolve(*names, shape=shp) == want, (names, shp)
        want = spec_from_jax(jctx.resolve(*names))
        assert ctx.resolve(*names) == want, names


def test_quirks_at_qwen2_full_width():
    """Two layouts of the reference's rules, reproduced as they are, at
    qwen2-1.5b's published shapes (28 layers) with model = 2: `embed`
    splits d_model, and a row-parallel `PimWeight`'s stacked scale
    [28, 1536] splits its layer dimension (its planes split K8)."""
    jcfg = j_get_config("qwen2-1.5b")
    j_tree = jax.eval_shape(lambda: j_quantize_tree(
        j_init_lm(jax.random.PRNGKey(0), jcfg),
        JPimQuantConfig(n_bits=8, group=1, impl="ref", min_features=1024)))
    tree = specs.abstract_params(get_config("qwen2-1.5b"), quantized=True)
    mesh = ((1, 2), ("data", "model"))
    with j_sharding_rules(StandIn(*mesh)):
        want = _flat(specs_from_jax(_jax_pims(j_partition_specs(j_tree))))
    with sharding_rules(Mesh(*mesh)):
        got = _flat(params_partition_specs(tree))
    assert got == want
    assert got["/embed"] == (None, "model")
    assert got["/layers/attn/wo/planes"] == (None, None, "model")
    assert got["/layers/attn/wo/scale"] == ("model",)
    assert got["/layers/mlp/w_down/scale"] == ("model",)
    assert got["/layers/attn/wq/scale"] == (None, "model")
    # ... and 2 layers of the smoke config on (2, 4) give no layer split
    j_small, small = _trees("qwen2-1.5b", True)
    with sharding_rules(Mesh((2, 4), ("data", "model"))):
        assert _flat(params_partition_specs(small))[
            "/layers/attn/wo/scale"] == ()


def test_place_tree_cuts_each_rank_its_block():
    """`place_tree` on an abstract mesh at each rank's coordinates: the
    blocks of all ranks tile the whole leaf, in the reference's device
    order (a tuple of axes splits with the first axis major)."""
    w = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    spec = (("pod", "data"), "model")
    blocks = {}
    for rank in range(8):
        m = Mesh(shape, axes, rank=rank)
        blocks[(m.axis_index(("pod", "data")), m.coords["model"])] = \
            sharding.place_tree({"w": w}, {"w": spec}, m)["w"]
    whole = torch.cat([torch.cat([blocks[(r, c)] for c in range(2)], dim=1)
                       for r in range(4)], dim=0)
    assert torch.equal(whole, w)


def _reference_specs() -> dict:
    """The reference's `param_shardings`, `cache_shardings`,
    `train_batch_specs`, `decode_token_spec` and `prefill_token_specs`
    on 8 forced host devices, as JSON."""
    body = textwrap.dedent("""
        import json, jax
        from jax.sharding import AxisType
        from repro.configs import SHAPES, get_config
        from repro.dist.sharding import SERVE_RULES, sharding_rules
        from repro.launch import specs
        out = {}
        def spec(s):
            return [None if e is None else e if isinstance(e, str) else list(e)
                    for e in s.spec]
        for shape, axes in CASES:
            mesh = jax.make_mesh(tuple(shape), tuple(axes),
                                 axis_types=(AxisType.Auto,) * len(axes))
            for arch, quant in ARCHS:
                cfg = get_config(arch, smoke=arch != "qwen2-1.5b")
                p = specs.abstract_params(cfg, quantized=quant)
                sh = specs.param_shardings(p, mesh)
                flat = jax.tree_util.tree_flatten_with_path(sh)[0]
                key = f"{shape}/{arch}/{quant}"
                out[key + "/params"] = {
                    jax.tree_util.keystr(k): spec(v) for k, v in flat}
                for cell in ("train_4k", "decode_32k", "long_500k"):
                    sc = SHAPES[cell]
                    with sharding_rules(mesh, SERVE_RULES):
                        cache = specs.cache_shardings(
                            specs.abstract_cache(cfg, sc), cfg, sc, mesh)
                    out[f"{key}/{cell}/cache"] = {
                        k: spec(v) for k, v in cache.items()}
                    out[f"{key}/{cell}/batch"] = {
                        k: spec(v) for k, v in
                        specs.train_batch_specs(cfg, sc, mesh)[1].items()}
                    out[f"{key}/{cell}/decode"] = spec(
                        specs.decode_token_spec(sc, mesh)[1])
                    out[f"{key}/{cell}/prefill"] = spec(
                        specs.prefill_token_specs(cfg, sc, mesh)[1])
        print("SPECS" + json.dumps(out))
    """)
    cases = [[[2, 4], ["data", "model"]], [[1, 8], ["data", "model"]],
             [[2, 2, 2], ["pod", "data", "model"]]]
    archs = [["qwen2-1.5b", True], ["granite-20b", False],
             ["zamba2-1.2b", False], ["xlstm-350m", False],
             ["whisper-medium", False], ["llava-next-34b", False]]
    script = f"CASES = {cases!r}\nARCHS = {archs!r}\n" + body
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=110)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("SPECS")][0]
    return json.loads(line[len("SPECS"):]), cases, archs


def _json_spec(s):
    out = [None if e is None else e if isinstance(e, str) else list(e)
           for e in s]
    while out and out[-1] is None:
        out.pop()
    return out


def test_launch_specs_equal_reference():
    """`param_shardings` (its divisibility fixup included: granite's
    single kv head, qwen2's 28 layers), `cache_shardings` for attention,
    Mamba2, xLSTM and encoder-decoder caches at the train_4k, decode_32k
    and long_500k cells, `train_batch_specs`, `decode_token_spec` and
    `prefill_token_specs`, on (2, 4), (1, 8) and (2, 2, 2) meshes."""
    want, cases, archs = _reference_specs()
    for shape, axes in cases:
        mesh = Mesh(shape, axes)
        for arch, quant in archs:
            cfg = get_config(arch, smoke=arch != "qwen2-1.5b")
            key = f"{shape}/{arch}/{quant}"
            p = specs.abstract_params(cfg, quantized=quant)
            got = {k: _json_spec(v) for k, v in _flat(
                specs.param_shardings(p, mesh)).items()}
            ref = {_ref_path(k): _json_spec(v)
                   for k, v in want[key + "/params"].items()}
            assert got == ref, key
            for cell in ("train_4k", "decode_32k", "long_500k"):
                sc = SHAPES[cell]
                with sharding_rules(mesh, SERVE_RULES):
                    cache = specs.cache_shardings(
                        specs.abstract_cache(cfg, sc), cfg, sc, mesh)
                assert {k: _json_spec(v) for k, v in cache.items()} == {
                    k: _json_spec(v)
                    for k, v in want[f"{key}/{cell}/cache"].items()}, cell
                assert {k: _json_spec(v) for k, v in specs.train_batch_specs(
                    cfg, sc, mesh)[1].items()} == {
                    k: _json_spec(v)
                    for k, v in want[f"{key}/{cell}/batch"].items()}, cell
                assert _json_spec(specs.decode_token_spec(sc, mesh)[1]) == \
                    _json_spec(want[f"{key}/{cell}/decode"])
                assert _json_spec(specs.prefill_token_specs(
                    cfg, sc, mesh)[1]) == _json_spec(
                        want[f"{key}/{cell}/prefill"])


def _ref_path(keystr: str) -> str:
    """`['layers']['attn']['wo'][<flat index 0>]` (jax keystr) -> the port's
    `/layers/attn/wo/planes`; a PimWeight's children flatten without
    names in the reference (`[<flat index 0>]`, `[<flat index 1>]`)."""
    path = keystr.replace("']['", "/").replace("['", "/").replace("']", "")
    return path.replace("[<flat index 0>]", "/planes").replace(
        "[<flat index 1>]", "/scale")


def test_meshes_outside_a_world():
    """Without a process group: the debug mesh is (1, 1) and abstract, the
    production meshes refuse a world that is not 256 / 512 ranks, and
    `mesh_chips` counts the mesh's ranks."""
    from repro_torch.launch.mesh import (make_debug_mesh,
                                         make_production_mesh, mesh_chips)

    debug = make_debug_mesh()
    assert debug.shape == {"data": 1, "model": 1} and mesh_chips(debug) == 1
    assert debug.ranks("model") == (0,)
    with pytest.raises(RuntimeError, match="no process group"):
        Mesh((2, 4), ("data", "model")).group("model")
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"world of {n} ranks"):
            make_production_mesh(multi_pod=multi_pod)
    assert mesh_chips(Mesh((2, 16, 16), ("pod", "data", "model"))) == 512


@pytest.mark.parametrize("group", [1, 2])
def test_packing_a_shard_equals_cutting_the_packed_whole(group):
    """A `PimWeight` is cut by its planes' and scale's specs. Column
    blocks (wq's M): quantizing and packing a rank's columns gives the
    cut planes and scale exactly (the scale is per column). Row blocks
    (wo's K8): a byte packs 8 / g consecutive rows, so packing a rank's
    rows of the quantized codes gives the cut planes (the scale stays
    the whole weight's: a row block's own absmax would differ)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator().manual_seed(0)
    cfg = get_config("qwen2-1.5b", smoke=True)
    qcfg = PimQuantConfig(n_bits=8, group=group, impl="ref", min_features=1)
    params = quantize_tree(init_lm(cfg, gen, "cpu",
                                   param_dtype=torch.float32), qcfg)
    dense = init_lm(cfg, torch.Generator().manual_seed(0), "cpu",
                    param_dtype=torch.float32)
    for rank in range(2):
        mesh = Mesh((1, 2), ("data", "model"), rank=rank)
        local = sharding.place_tree(params, specs.param_shardings(params,
                                                                  mesh), mesh)
        wq = dense["layers"]["attn"]["wq"][0]
        m = wq.shape[1] // 2
        planes, scale = ops.quantize_and_pack(wq[:, rank * m:(rank + 1) * m],
                                              8, group, "ref")
        assert torch.equal(planes, local["layers"]["attn"]["wq"].planes[0])
        assert torch.equal(scale, local["layers"]["attn"]["wq"].scale[0])
        wo = dense["layers"]["attn"]["wo"][0]
        w_q, _ = ref.quantize_ref(wo, 8)
        k = wo.shape[0] // 2
        planes = ref.pack_ref(w_q[rank * k:(rank + 1) * k], 8, group)
        assert torch.equal(planes, local["layers"]["attn"]["wo"].planes[0])

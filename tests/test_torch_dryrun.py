"""The port's dry run (`repro_torch.launch.dryrun`) on the CPU, under a
fake world of 256 / 512 ranks.

* `run_cell` gives `ok` for qwen2-1.5b `decode_32k` on 2 x 16 x 16 and
  `train_4k` on 16 x 16, and for qwen2.5-14b `decode_32k` on 16 x 16:
  rank 0's argument bytes equal the bytes reckoned from the reference's
  own `param_shardings` / `cache_shardings` / batch specs on stand-in
  meshes (each leaf's bytes over the product of the mesh axes its spec
  names), the roofline terms are finite and positive, and the
  collectives a tensor-parallel step issues are counted.
* The cells the port does not run tensor-parallel (MoE, recurrent and
  encoder-decoder stacks on a `model` axis of 16) are pinned: every
  applicable cell of those five archs, on both meshes, ends
  `unsupported` with the model's refusal as its reason; none crashes,
  and no dense attention arch is among them.
* The fake world is gone after a cell.

The reference's spec functions build `NamedSharding`s, which need real
devices; a stand-in mesh (`shape` and `axis_names`, all its rules read)
takes their place, and `NamedSharding` is patched to return the spec.
"""

import math

import jax
import pytest
import torch.distributed as dist

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.dist.sharding import SERVE_RULES as J_SERVE_RULES
from repro.dist.sharding import TRAIN_RULES as J_TRAIN_RULES
from repro.dist.sharding import sharding_rules as j_sharding_rules
from repro.launch import specs as JS
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch.dryrun import main, run_cell

#: the cells a `model` axis of 16 refuses, by arch (every applicable
#: shape, on both production meshes)
UNSUPPORTED_ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e",
                     "zamba2-1.2b", "xlstm-350m", "whisper-medium")
UNSUPPORTED_CELLS = {
    (a, s, m)
    for a in UNSUPPORTED_ARCHS for s in SHAPES for m in ("single", "multi")
    if shape_applicable(get_config(a), SHAPES[s])[0]
}
N_UNSUPPORTED = 34


class StandIn:
    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def _spec_bytes(leaf, spec, mesh) -> int:
    n = math.prod(leaf.shape) * leaf.dtype.itemsize
    for entry in tuple(spec):
        for ax in ((entry,) if isinstance(entry, str) else (entry or ())):
            n //= mesh.shape[ax]
    return n


def _tree_bytes(tree, specs, mesh) -> int:
    is_p = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa: E731
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=is_p)
    assert len(leaves) == len(spec_leaves)
    return sum(_spec_bytes(l, s, mesh) for l, s in zip(leaves, spec_leaves))


def _reference_bytes(monkeypatch, arch, shape_name, multi) -> int:
    """Rank 0's argument bytes by the reference's specs."""
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)
    cfg, shape = j_get_config(arch), J_SHAPES[shape_name]
    mesh = (StandIn((2, 16, 16), ("pod", "data", "model")) if multi
            else StandIn((16, 16), ("data", "model")))
    params = JS.abstract_params(cfg)
    if shape.kind == "train":
        p_specs = JS.param_shardings(params, mesh, J_TRAIN_RULES)
        batch, b_specs = JS.train_batch_specs(cfg, shape, mesh)
        return (3 * _tree_bytes(params, p_specs, mesh) + 4   # m, v, step
                + _tree_bytes(batch, b_specs, mesh))
    p_specs = JS.param_shardings(params, mesh, J_SERVE_RULES)
    cache = JS.abstract_cache(cfg, shape)
    with j_sharding_rules(mesh, J_SERVE_RULES):
        c_specs = JS.cache_shardings(cache, cfg, shape, mesh)
    cache = {k: v for k, v in cache.items() if k != "position"}
    c_specs = {k: c_specs[k] for k in cache}
    tok, t_spec = JS.decode_token_spec(shape, mesh)
    return (_tree_bytes(params, p_specs, mesh)
            + _tree_bytes(cache, c_specs, mesh)
            + _spec_bytes(tok, t_spec, mesh))


@pytest.mark.parametrize("arch,shape,multi", [
    ("qwen2-1.5b", "decode_32k", True),
    ("qwen2-1.5b", "train_4k", False),
    ("qwen2.5-14b", "decode_32k", False),
], ids=["qwen2-decode_32k-multi", "qwen2-train_4k-single",
        "qwen2.5-decode_32k-single"])
def test_dense_cells_ok_with_the_reference_bytes(monkeypatch, arch, shape,
                                                  multi):
    r = run_cell(arch, shape, multi)
    assert not dist.is_initialized()
    assert r["status"] == "ok", r
    assert r["chips"] == (512 if multi else 256)
    assert r["argument_bytes"] == _reference_bytes(monkeypatch, arch, shape,
                                                   multi)
    assert r["temp_bytes"] is not None and r["temp_bytes"] > 0, r
    assert r["bytes_per_device"] == r["argument_bytes"] + r["temp_bytes"]
    rf = r["roofline"]
    for key in ("compute_s", "memory_s", "collective_s", "bound_s"):
        assert math.isfinite(rf[key]) and rf[key] > 0, (key, rf)
    assert r["detail"]["collectives_by_kind"].get("all_reduce", 0) > 0
    assert r["trace_s"] >= 0


def test_unsupported_cells_are_pinned():
    assert len(UNSUPPORTED_CELLS) == N_UNSUPPORTED
    seen = set()
    for arch, shape, mesh in sorted(UNSUPPORTED_CELLS):
        r = run_cell(arch, shape, mesh == "multi")
        assert not dist.is_initialized()
        assert r["status"] == "unsupported", r
        assert "without a model axis" in r["reason"], r
        seen.add((arch, shape, mesh))
    assert seen == UNSUPPORTED_CELLS
    dense = {a for a in ARCH_IDS if a not in UNSUPPORTED_ARCHS}
    for a in dense:
        cfg = get_config(a)
        assert cfg.block_kind == "attn" and not cfg.n_experts \
            and not cfg.is_encoder_decoder, a


def test_skipped_cells_keep_the_reference_reason():
    r = run_cell("qwen2-1.5b", "long_500k", True)
    assert r == {"cell": "qwen2-1.5b|long_500k|multi", "status": "skipped",
                 "reason": "pure full-attention arch: long_500k skipped "
                           "(DESIGN.md §4)"}


def test_cli_writes_the_artifact(tmp_path, capsys):
    main(["--arch", "gemma3-27b", "--shape", "decode_32k", "--mesh",
          "single", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[OK] gemma3-27b|decode_32k|single" in out
    files = list(tmp_path.glob("*.json"))
    assert [f.name for f in files] == ["gemma3-27b__decode_32k__single.json"]

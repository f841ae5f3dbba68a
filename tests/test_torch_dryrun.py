"""The port's dry run (`repro_torch.launch.dryrun`) on the CPU, under a
fake world of 256 / 512 ranks.

* `run_cell` gives `ok` for qwen2-1.5b `decode_32k` on 2 x 16 x 16 and
  `train_4k` on 16 x 16, and for qwen2.5-14b `decode_32k` on 16 x 16:
  rank 0's argument bytes equal the bytes reckoned from the reference's
  own `param_shardings` / `cache_shardings` / batch specs on stand-in
  meshes (each leaf's bytes over the product of the mesh axes its spec
  names), the roofline terms are finite and positive, and the
  collectives a tensor-parallel step issues are counted.
* The MoE, recurrent and encoder-decoder stacks run tensor-parallel on
  the same terms: `decode_32k` of phi3.5-moe, llama4-scout, zamba2,
  xlstm and whisper on 16 x 16, zamba2's `long_500k` on 2 x 16 x 16 and
  zamba2's `decode_32k` with bit-plane weights (bytes from the
  reference's `abstract_params(cfg, quantized=True)`) give `ok` with the
  reference's bytes and counted collectives.
* xlstm-350m's `train_4k` and llava-next-34b's `prefill_32k`, whose
  loops over positions and blocks are `models.scan`s, end `ok` with the
  reference's bytes, as `chip_smoke.py` pins them.
* Pinned cells: with the loops on `models.scan` the dry run gives the
  argument bytes, temp bytes, FLOPs and collectives the whole loops
  gave, but for the two changes `test_pinned_cells_...` names.
* The paged path still refuses a `model` axis
  (`TensorParallelUnsupported`).
* The fake world is gone after a cell.

The reference's spec functions build `NamedSharding`s, which need real
devices; a stand-in mesh (`shape` and `axis_names`, all its rules read)
takes their place, and `NamedSharding` is patched to return the spec.
"""

import importlib.util
import math
import os

import jax
import pytest
import torch
import torch.distributed as dist

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.dist.sharding import SERVE_RULES as J_SERVE_RULES
from repro.dist.sharding import TRAIN_RULES as J_TRAIN_RULES
from repro.dist.sharding import sharding_rules as j_sharding_rules
from repro.launch import specs as JS
from repro_torch.configs import get_config
from repro_torch.dist.sharding import (
    SERVE_RULES,
    TensorParallelUnsupported,
    sharding_rules,
)
from repro_torch.launch.dryrun import main, run_cell
from repro_torch.launch.mesh import Mesh
from repro_torch.models import decode_step_paged, init_lm, init_paged_pool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (arch, shape, multi-pod, bit-plane weights) of the MoE, recurrent and
#: encoder-decoder cells held against the reference's bytes
FAMILY_CELLS = [
    ("phi3.5-moe-42b-a6.6b", "decode_32k", False, False),
    ("llama4-scout-17b-a16e", "decode_32k", False, False),
    ("zamba2-1.2b", "decode_32k", False, False),
    ("xlstm-350m", "decode_32k", False, False),
    ("whisper-medium", "decode_32k", False, False),
    ("zamba2-1.2b", "long_500k", True, False),
    ("zamba2-1.2b", "decode_32k", False, True),
]


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


def _reference_bytes(monkeypatch, arch, shape_name, multi,
                     quantized=False) -> int:
    """Rank 0's argument bytes by the reference's specs (`shape_name`: a
    shape's name, or the reference's `ShapeConfig` itself)."""
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)
    cfg = j_get_config(arch)
    shape = (J_SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    mesh = (StandIn((2, 16, 16), ("pod", "data", "model")) if multi
            else StandIn((16, 16), ("data", "model")))
    params = JS.abstract_params(cfg, quantized=quantized)
    if shape.kind == "train":
        p_specs = JS.param_shardings(params, mesh, J_TRAIN_RULES)
        batch, b_specs = JS.train_batch_specs(cfg, shape, mesh)
        return (3 * _tree_bytes(params, p_specs, mesh) + 4   # m, v, step
                + _tree_bytes(batch, b_specs, mesh))
    p_specs = JS.param_shardings(params, mesh, J_SERVE_RULES)
    if shape.kind == "prefill":
        tok, t_spec = JS.prefill_token_specs(cfg, shape, mesh)
        n = _tree_bytes(params, p_specs, mesh)
        if cfg.frontend == "vision_stub":   # the stub's positions
            nf = cfg.frontend_tokens        # are not tokens
            b, t = tok.shape
            tok = jax.ShapeDtypeStruct((b, t - nf), tok.dtype)
            patches = jax.ShapeDtypeStruct((b, nf, cfg.d_model),
                                           jax.numpy.float32)
            n += _spec_bytes(patches, t_spec, mesh)
        return n + _spec_bytes(tok, t_spec, mesh)
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


@pytest.mark.parametrize(
    "arch,shape,multi,quantized", FAMILY_CELLS,
    ids=[f"{a.split('-')[0]}-{s}-{'multi' if m else 'single'}"
         + ("-pim" if q else "") for a, s, m, q in FAMILY_CELLS])
def test_family_cells_ok_with_the_reference_bytes(monkeypatch, arch, shape,
                                                  multi, quantized):
    """The stacks that refused a `model` axis before now run on it: rank
    0's argument bytes equal the reference's specs', the temp bytes are
    measured, and the step's collectives are counted (the row-parallel
    all-reduces; zamba2's and xlstm's decode also gather their recurrent
    states)."""
    r = run_cell(arch, shape, multi, quantized=quantized)
    assert not dist.is_initialized()
    assert r["status"] == "ok", r
    assert r["argument_bytes"] == _reference_bytes(monkeypatch, arch, shape,
                                                   multi, quantized)
    assert r["temp_bytes"] is not None and r["temp_bytes"] > 0, r
    kinds = r["detail"]["collectives_by_kind"]
    assert kinds.get("all_reduce", 0) > 0, kinds
    if get_config(arch).block_kind != "attn" and shape != "long_500k":
        assert kinds.get("all_gather", 0) > 0, kinds
    rf = r["roofline"]
    for key in ("compute_s", "memory_s", "collective_s", "bound_s"):
        assert math.isfinite(rf[key]) and rf[key] > 0, (key, rf)


def test_paged_path_refuses_a_model_axis():
    """Paged serving runs on one rank, as the reference's does: under a
    `model` axis its layer loop raises `TensorParallelUnsupported`."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    k_pages, v_pages = init_paged_pool(cfg, 4, 4, device="cpu")
    table = torch.zeros((1, 2), dtype=torch.int32)
    pos = torch.zeros((1,), dtype=torch.int32)
    with sharding_rules(Mesh((1, 2), ("data", "model")), SERVE_RULES):
        with pytest.raises(TensorParallelUnsupported, match="one rank"):
            decode_step_paged(params, torch.zeros((1, 1), dtype=torch.int64),
                              k_pages, v_pages, table, pos, cfg,
                              impl="ref")


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


def test_llava_train_step_gathers_the_split_patches():
    """A training batch's spec splits the stub patches' d_model over
    `model` (as the reference's `train_batch_specs`): llava's step on
    16 x 16 gathers that block before joining it to the embedding (it
    raised on the size mismatch before). Smoke widths, 64 positions."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import TRAIN_RULES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_production_mesh

    cfg = dataclasses.replace(get_config("llava-next-34b", smoke=True),
                              frontend_tokens=16)
    shape = ShapeConfig("train_64", 64, 256, "train")
    with D.fake_world(256):
        mesh = make_production_mesh()
        with sharding_rules(mesh, TRAIN_RULES,
                            rows=S.batch_rows(mesh, shape.global_batch)):
            step, args = D.build_step(cfg, shape, mesh)
            assert args[2]["patches"].shape[-1] < cfg.d_model
            _, _, metrics = step()
    assert metrics["loss"].shape == ()
    assert not dist.is_initialized()


def test_xlstm_train_step_at_published_width(monkeypatch):
    """xlstm-350m's training step at its published width on 16 x 16: at
    16 positions, the mLSTM's q / k / v blocks (128 of a head's 512
    columns) are gathered whole and their gradients cut back, `w_down`'s
    partial sums all-reduced, and rank 0's argument bytes equal the
    reference's specs' for the same shape; the loss is a scalar. Then the
    whole `train_4k` cell through `run_cell` (its time loops are
    `models.scan`s, so 4,096 positions trace in seconds): `ok`, its
    argument bytes the reference's and `chip_smoke.py`'s pinned bytes."""
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import TRAIN_RULES
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config("xlstm-350m")
    shape = ShapeConfig("train_16", 16, 256, "train")
    with D.fake_world(256):
        mesh = make_production_mesh()
        with sharding_rules(mesh, TRAIN_RULES,
                            rows=S.batch_rows(mesh, shape.global_batch)):
            step, args = D.build_step(cfg, shape, mesh)
            hd = cfg.ssm_expand * cfg.d_model // cfg.n_heads
            assert args[0]["layers"]["mlstm"]["wq"].shape[-1] < hd
            collectives.reset_counts()
            _, _, metrics = step()
            counts = collectives.read_counts()
    assert not dist.is_initialized()
    assert metrics["loss"].shape == ()
    assert counts["all_gather"]["calls"] > 0
    assert counts["all_reduce"]["calls"] > 0
    arg_bytes = sum(t.numel() * t.element_size()
                    for a in args for t in D._tensors(a))
    assert arg_bytes == _reference_bytes(
        monkeypatch, "xlstm-350m",
        JShapeConfig("train_16", 16, 256, "train"), False)

    r = run_cell("xlstm-350m", "train_4k", False)
    assert not dist.is_initialized()
    assert r["status"] == "ok", r
    assert r["temp_bytes"] > 0
    kinds = r["detail"]["collectives_by_kind"]
    assert kinds["all_gather"] > 0 and kinds["all_reduce"] > 0
    want = _reference_bytes(monkeypatch, "xlstm-350m", "train_4k", False)
    assert r["argument_bytes"] == want
    assert _chip_smoke().TOOLS_DRYRUN_BYTES[r["cell"]] == want


def test_llava_prefill_32k_cell_with_the_reference_bytes(monkeypatch):
    """llava-next-34b's `prefill_32k` on 16 x 16: 60 layers of dense
    attention over 32,768 positions, each a walk of 64 x 32 blocks that
    `models.scan` shortens on meta. Rank 0's argument bytes (params,
    tokens, stub patches) equal the reference's specs' and
    `chip_smoke.py`'s pinned bytes."""
    r = run_cell("llava-next-34b", "prefill_32k", False)
    assert r["status"] == "ok", r
    want = _reference_bytes(monkeypatch, "llava-next-34b", "prefill_32k",
                            False)
    assert r["argument_bytes"] == want
    assert _chip_smoke().TOOLS_DRYRUN_BYTES[r["cell"]] == want
    assert r["temp_bytes"] > 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# pinned cells: what the dry run gave before its loops ran on `models.scan`
# ---------------------------------------------------------------------------

#: (arch, shape name, positions, global batch, kind) -> rank 0's argument
#: bytes, temp bytes, counted aten FLOPs and {collective: [calls, bytes]}
#: on 16 x 16, as the dry run gave them when every loop stepped through
#: all its positions, blocks and chunks on meta (about a second a
#: position for xlstm's training step)
PINNED = {
    ("xlstm-350m", "train_16", 16, 256, "train"): (
        2_609_690_628, 2_374_936_009, 203_604_099_072,
        {"all_reduce": [179, 1_757_990_444],
         "all_gather": [284, 138_608_640]}),
    ("xlstm-350m", "train_64", 64, 256, "train"): (
        2_609_696_772, 5_633_189_833, 814_819_049_472,
        {"all_reduce": [179, 2_138_795_564],
         "all_gather": [284, 554_434_560]}),
    ("qwen2-1.5b", "train_4k", 4096, 256, "train"): (
        1_159_940_100, 103_216_625_737, 230_229_037_547_520,
        {"all_reduce": [298, 90_912_656_684],
         "all_gather": [564, 19_755_601_920]}),
    ("qwen2-1.5b", "prefill_8k", 8192, 32, "prefill"): (
        386_537_472, 996_212_992, 25_773_083_344_896,
        {"all_reduce": [57, 5_285_962_560],
         "all_gather": [85, 1_808_793_600]}),
    ("phi3.5-moe-42b-a6.6b", "train_128", 128, 256, "train"): (
        484_415_832_068, 376_606_531_657, 1_651_326_811_373_568,
        {"all_reduce": [337, 306_314_557_484],
         "all_gather": [388, 16_748_298_240],
         "reduce_scatter": [64, 8_053_063_680]}),
    ("zamba2-1.2b", "prefill_2k", 2048, 32, "prefill"): (
        3_912_373_504, 511_334_080, 8_662_696_984_576,
        {"all_reduce": [13, 377_727_360], "all_gather": [1, 15_728_640]}),
}


@pytest.mark.parametrize("cell", sorted(PINNED), ids=lambda c: f"{c[0]}-{c[1]}")
def test_pinned_cells_count_what_the_whole_loops_counted(cell):
    """The dry run with its loops on `models.scan` (steps 0, 1, 2 and the
    last run on meta, the others accounted for) against the numbers the
    whole loops gave. Equal, but for two named changes:

    * the batch re-lay of a training step in microbatches under a data
      split (`train.step`): one all-gather of tokens and one of targets
      over `data` (15 blocks of 16 rows each), whose result, the re-laid
      16 rows, is alive through the step;
    * Mamba2's chunk outputs: the loop kept its list of them to the end
      of `mamba2_forward`, the scan frees it once they are joined, so the
      peak after the scan is lower by the 8 chunk outputs of
      [2 rows, 256, 4096] f32 of one layer."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import collectives

    arch, name, t, b, kind = cell
    args, temp, flops, counts = PINNED[cell]
    counts = {k: list(v) for k, v in counts.items()}
    if kind == "train":
        batch = 2 * (b // 16) * t * 4            # tokens, targets: int32
        temp += batch
        counts["all_gather"][0] += 2
        counts["all_gather"][1] += 15 * batch
    if arch == "zamba2-1.2b":
        temp -= 8 * 2 * 256 * 4096 * 4
    collectives.reset_counts()
    r = run_cell(arch, ShapeConfig(name, t, b, kind), False)
    got = {k: [v["calls"], v["bytes"]]
           for k, v in collectives.read_counts().items()
           if v["calls"] and k != "staged"}
    assert r["status"] == "ok", r
    assert (r["argument_bytes"], r["temp_bytes"]) == (args, temp)
    assert r["detail"]["counted_flops"] == {"aten": flops, "kernels": 0}
    assert got == counts

"""Paged model forward of the PyTorch port against the JAX reference.

The reference's own `init_lm` parameters cross through numpy
(`bridge.params_from_jax`); `prefill_paged` and `decode_step_paged` then
run in both packages (JAX `impl="ref"`, the port's plain kernels) on the
same tables, tokens and positions, in f32 (qwen2-1.5b smoke).

Tolerances: logits atol 1e-4; updated float pools atol 1e-5. int8
pools: the codes are EXACTLY equal in every case here, and the per-page
scales agree to f32 rounding (rtol 1e-6) — a scale is the absmax of the
projected K/V, which the two frameworks' matmuls round differently in
the last bit. A code could in principle land one apart where a value
sits on a rounding boundary; none does in these cases.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import decode_step_paged as j_decode
from repro.models import init_lm as j_init_lm
from repro.models import init_paged_pool as j_init_pool
from repro.models import prefill_paged as j_prefill
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import (
    decode_step_paged,
    init_lm,
    init_paged_pool,
    prefill_paged,
)

LOGIT_TOL = dict(rtol=0, atol=1e-4)
POOL_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(j_get_config("qwen2-1.5b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype="float32")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def _assert_pools(jpools, tpools, quantized):
    names = ("k_pages", "v_pages", "k_scales", "v_scales")
    for name, a, b in zip(names, jpools, tpools):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if not quantized:
            np.testing.assert_allclose(b, a, **POOL_TOL, err_msg=name)
        elif name.endswith("pages"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=name)


def _run_both(models, kv_dtype, steps):
    """Drive both packages through the same sequence of paged prefill /
    decode calls on shared pools; compare logits and pools after each."""
    jcfg, jp, cfg, tp = models
    nb, bs = 16, 4
    jpools = [jnp.asarray(x) for x in j_init_pool(jcfg, nb, bs, kv_dtype)]
    tpools = list(init_paged_pool(cfg, nb, bs, kv_dtype, device="cpu"))
    quantized = kv_dtype == "int8"
    for kind, bt, toks, a, b, last in steps:
        jbt, tbt = jnp.asarray(bt), torch.tensor(bt)
        jscales = dict(k_scales=jpools[2], v_scales=jpools[3]) \
            if quantized else {}
        tscales = dict(k_scales=tpools[2], v_scales=tpools[3]) \
            if quantized else {}
        if kind == "prefill":
            jr = j_prefill(jp, jnp.asarray(toks), jpools[0], jpools[1], jbt,
                           jnp.asarray(a), jnp.asarray(b), jcfg,
                           last_pos=jnp.asarray(last), impl="ref", **jscales)
            tr = prefill_paged(tp, torch.tensor(toks), tpools[0], tpools[1],
                               tbt, torch.tensor(a), torch.tensor(b), cfg,
                               last_pos=last, impl="ref", **tscales)
        else:
            jr = j_decode(jp, jnp.asarray(toks), jpools[0], jpools[1], jbt,
                          jnp.asarray(a), jcfg, impl="ref", **jscales)
            tr = decode_step_paged(tp, torch.tensor(toks), tpools[0],
                                   tpools[1], tbt, torch.tensor(a), cfg,
                                   impl="ref", **tscales)
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]),
                                   **LOGIT_TOL)
        jpools, tpools = list(jr[1:]), list(tr[1:])
        _assert_pools(jpools, tpools, quantized)


def _steps(rng):
    """Two slots: a full prefill and a prefix-offset chunk (start > 0),
    both with pad rows, then three decode steps whose positions cross a
    page boundary; the tables share a page (COW-fragmented)."""
    i32 = lambda x: np.asarray(x, np.int32)
    bt = i32([[3, 7, 1, 9, 11], [5, 2, 12, 4, 14]])
    steps = [
        ("prefill", bt, rng.integers(0, 128, (2, 8)).astype(np.int32),
         i32([0, 0]), i32([7, 5]), 6),
        ("prefill", bt, rng.integers(0, 128, (2, 8)).astype(np.int32),
         i32([7, 5]), i32([13, 11]), 5),
    ]
    pos = [13, 11]
    for _ in range(3):
        steps.append(("decode", bt,
                      rng.integers(0, 128, (2, 1)).astype(np.int32),
                      i32(pos), None, None))
        pos = [p + 1 for p in pos]
    return steps


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_and_decode_match_reference(rng, models, kv_dtype):
    _run_both(models, kv_dtype, _steps(rng))


def test_prefill_with_idle_rows_and_scratch_pad_rows(rng, models):
    """An idle slot (all-scratch table, total 0) rides a batched prefill
    and decode; pad rows past a short table land in scratch page 0."""
    i32 = lambda x: np.asarray(x, np.int32)
    bt = i32([[0, 0], [6, 8]])
    steps = [
        ("prefill", bt, rng.integers(0, 128, (2, 8)).astype(np.int32),
         i32([0, 0]), i32([0, 7]), 6),
        ("decode", bt, rng.integers(0, 128, (2, 1)).astype(np.int32),
         i32([0, 7]), None, None),
    ]
    for kv_dtype in ("bf16", "int8"):
        _run_both(models, kv_dtype, steps)


def test_bridge_dtypes_and_layout(models):
    jcfg, jp, cfg, tp = models
    assert tp["layers"]["attn"]["wq"].shape == (cfg.n_layers, cfg.d_model,
                                                cfg.n_heads * cfg.hd)
    bf = params_from_jax(jax.tree.map(np.asarray, jp),
                         get_config("qwen2-1.5b", smoke=True), "cpu")
    assert bf["embed"].dtype == torch.bfloat16
    assert bf["layers"]["attn"]["bq"].dtype == torch.bfloat16
    assert bf["layers"]["ln1"]["g"].dtype == torch.float32
    assert bf["final_norm"]["g"].dtype == torch.float32


def test_port_init_lm_shapes_and_scales():
    """The port's own init: the reference's tree shapes, weights in the
    compute dtype, gains f32, and the reference's init scales."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    jcfg = j_get_config("qwen2-1.5b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    tp = init_lm(cfg, gen, device="cpu")
    jshapes = jax.tree.map(
        lambda x: tuple(x.shape),
        jax.eval_shape(lambda k: j_init_lm(k, jcfg), jax.random.PRNGKey(0)),
    )
    tshapes = jax.tree.map(lambda x: tuple(x.shape), tp)
    assert tshapes == jshapes
    assert tp["layers"]["mlp"]["w_up"].dtype == torch.bfloat16
    assert tp["layers"]["ln2"]["g"].dtype == torch.float32
    w = tp["layers"]["mlp"]["w_down"].float()
    std = 1.0 / np.sqrt(cfg.d_ff)
    assert float(w.abs().max()) <= 3.0 * std * 1.01
    assert abs(float(w.std()) / std - 0.987) < 0.05  # truncated at 3 sigma
    assert abs(float(tp["embed"].float().std()) - 0.02) < 0.004
    again = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["embed"], tp["embed"])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-27b"])
@pytest.mark.parametrize("smoke", [True, False])
def test_layer_shapes_equal_the_meta_device_init(arch, smoke):
    """`layer_shapes`, which `init_lm` allocates its stack from, gives
    `init_layer`'s tree of shapes and dtypes without running it."""
    from repro_torch.models.common import compute_dtype
    from repro_torch.models.transformer import init_layer, layer_shapes

    cfg = get_config(arch, smoke=smoke)
    dt = compute_dtype(cfg.dtype)
    meta = init_layer(cfg, None, torch.device("meta"), dt)
    want = jax.tree.map(lambda x: (tuple(x.shape), x.dtype), meta)
    got = jax.tree.map(lambda x: x, layer_shapes(cfg, dt),
                       is_leaf=lambda x: isinstance(x, tuple))
    assert got == want


@pytest.mark.parametrize("quantized", [False, True])
def test_count_params_equals_reference(models, quantized):
    from repro.models import count_params as j_count_params
    from repro.quant.bitplane import PimQuantConfig as JQuantConfig
    from repro.quant.bitplane import quantize_tree as j_quantize_tree
    from repro_torch.models import count_params
    from repro_torch.quant import PimQuantConfig, quantize_tree

    _, jp, _, tp = models
    if quantized:
        jp = j_quantize_tree(jp, JQuantConfig(8, 1, min_features=1))
        tp = quantize_tree(tp, PimQuantConfig(8, 1, min_features=1))
    assert count_params(tp) == j_count_params(jp)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-27b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_lm_equals_stacked_per_layer_draws(arch, dtype):
    """`init_lm` fills preallocated `[L, ...]` leaves layer by layer; it
    returns exactly what drawing each layer's tree in turn from the same
    generator and stacking them gives (then the embedding), bit for bit."""
    from repro_torch.models.common import compute_dtype, embed_init
    from repro_torch.models.transformer import init_layer

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    got = init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    gen = torch.Generator().manual_seed(3)
    dt = compute_dtype(dtype)
    layers = [init_layer(cfg, gen, "cpu", dt) for _ in range(cfg.n_layers)]
    want = {
        "layers": jax.tree.map(lambda *xs: torch.stack(xs), *layers),
        "embed": embed_init(cfg.vocab_size, cfg.d_model, gen, "cpu", dt),
    }
    got_leaves = jax.tree.leaves_with_path(got)
    want_leaves = dict(jax.tree.leaves_with_path(want))
    assert len(got_leaves) == len(want_leaves) + 1      # + final_norm
    for path, x in got_leaves:
        if path in want_leaves:
            y = want_leaves[path]
            assert x.dtype == y.dtype and torch.equal(x, y), path
    assert torch.equal(got["final_norm"]["g"], torch.ones(cfg.d_model))

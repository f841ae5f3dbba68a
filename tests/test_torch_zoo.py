"""The rest of the attention model zoo in the port against the JAX
reference: qwen2.5-14b (a config copy), granite-20b (plain GELU MLP,
MQA), phi3.5-moe-42b-a6.6b (16 experts, top-2) and llama4-scout-17b-a16e
(top-1 and a shared expert).

The reference's own `init_lm` parameters of each smoke config cross
through numpy (`bridge.params_from_jax`); `forward`, `prefill` /
`decode_step` and `prefill_paged` / `decode_step_paged` then run in
both packages (JAX `impl="ref"`, the port's plain kernels) on the same
tokens, tables and positions, in f32.

Tolerances: logits atol 1e-4 (`LOGIT_TOL`, as in test_torch_model.py);
`moe_aux` atol 1e-5; dense caches and float pools atol 1e-5; int8 pools'
codes exactly equal and their scales within rtol 1e-6 (the rules of
test_torch_model.py); the MLP block within 1e-5. Configs equal field by
field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import count_params as j_count_params
from repro.models import decode_step as j_decode
from repro.models import decode_step_paged as j_decode_paged
from repro.models import forward as j_forward
from repro.models import init_lm as j_init_lm
from repro.models import init_paged_pool as j_init_pool
from repro.models import prefill as j_prefill
from repro.models import prefill_paged as j_prefill_paged
from repro.models import mlp as j_mlp
from repro.quant.bitplane import PimQuantConfig as JQuantConfig
from repro.quant.bitplane import quantize_tree as j_quantize_tree
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import PORT_FIELDS, ModelConfig
from repro_torch.models import (
    count_params,
    decode_step,
    decode_step_paged,
    forward,
    init_lm,
    init_paged_pool,
    prefill,
    prefill_paged,
)
from repro_torch.models import mlp as t_mlp
from repro_torch.models.common import compute_dtype
from repro_torch.models.transformer import init_layer, layer_shapes
from repro_torch.quant import PimQuantConfig, quantize_tree

ZOO = ["qwen2.5-14b", "granite-20b", "phi3.5-moe-42b-a6.6b",
       "llama4-scout-17b-a16e"]
LOGIT_TOL = dict(rtol=0, atol=1e-4)
AUX_TOL = dict(rtol=0, atol=1e-5)
CACHE_TOL = dict(rtol=0, atol=1e-5)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module", params=ZOO)
def models(request):
    jcfg = _f32(j_get_config(request.param, smoke=True))
    cfg = _f32(get_config(request.param, smoke=True))
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def _tokens(vocab, shape, seed):
    t = np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)
    return jnp.asarray(t), torch.from_numpy(t)


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


# ---------------------------------------------------------------------------
# configs, init, bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference(arch, smoke):
    """Every field of `config()` and `smoke()` that the reference's config
    has equal to the reference's (exact), and the port-only fields
    (YaRN) at their defaults, which leave the arithmetic as it was."""
    assert arch in ARCH_IDS
    cfg = get_config(arch, smoke=smoke)
    want = dataclasses.asdict(j_get_config(arch, smoke=smoke))
    got = dataclasses.asdict(cfg)
    assert {k: v for k, v in got.items() if k not in PORT_FIELDS} == want
    assert all(got[k] == getattr(ModelConfig, k) for k in PORT_FIELDS)


@pytest.mark.parametrize("arch", ZOO)
@pytest.mark.parametrize("smoke", [True, False])
def test_layer_shapes_equal_the_meta_device_init(arch, smoke):
    """`layer_shapes` gives `init_layer`'s tree of shapes and dtypes
    exactly: the `mlp` (plain: w_up, w_down) or `moe` subtree, router in
    f32."""
    cfg = get_config(arch, smoke=smoke)
    dt = compute_dtype(cfg.dtype)
    meta = init_layer(cfg, None, torch.device("meta"), dt)
    want = jax.tree.map(lambda x: (tuple(x.shape), x.dtype), meta)
    got = jax.tree.map(lambda x: x, layer_shapes(cfg, dt),
                       is_leaf=lambda x: isinstance(x, tuple))
    assert got == want
    if cfg.n_experts:
        assert got["moe"]["router"] == ((cfg.d_model, cfg.n_experts),
                                        torch.float32)
        assert ("shared" in got["moe"]) == bool(cfg.n_shared_experts)
    elif cfg.mlp_kind == "plain":
        assert sorted(got["mlp"]) == ["w_down", "w_up"]


@pytest.mark.parametrize("arch", ZOO)
def test_port_init_lm_matches_reference_tree(arch):
    """The port's own init in bf16: the reference's tree of shapes
    (exact), weights in bf16, norm gains and routers f32; expert stacks
    at the reference's fan-in scales (|w| <= 3.03 std, the truncated
    std within 5% of 0.987 std)."""
    cfg = get_config(arch, smoke=True)
    jcfg = j_get_config(arch, smoke=True)
    tp = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree.map(
        lambda x: tuple(x.shape),
        jax.eval_shape(lambda k: j_init_lm(k, jcfg), jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda x: tuple(x.shape), tp) == jshapes
    layers = tp["layers"]
    if cfg.n_experts:
        assert layers["moe"]["router"].dtype == torch.float32
        assert layers["moe"]["we_gate"].dtype == torch.bfloat16
        w = layers["moe"]["we_down"].float()
        std = 1.0 / np.sqrt(cfg.d_ff)
        assert float(w.abs().max()) <= 3.0 * std * 1.01
        assert abs(float(w.std()) / std - 0.987) < 0.05
    else:
        assert layers["mlp"]["w_up"].dtype == torch.bfloat16


def test_bridge_keeps_router_f32(models):
    """A bf16 config's tree from the bridge: routers and norm gains stay
    f32, every other weight is bf16 (exact dtypes)."""
    jcfg, jp, cfg, tp = models
    bf = params_from_jax(jax.tree.map(np.asarray, jp),
                         dataclasses.replace(cfg, dtype="bfloat16"), "cpu")
    assert bf["layers"]["ln2"]["g"].dtype == torch.float32
    if cfg.n_experts:
        assert bf["layers"]["moe"]["router"].dtype == torch.float32
        assert bf["layers"]["moe"]["we_up"].dtype == torch.bfloat16
    else:
        assert bf["layers"]["mlp"]["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("quantized", [False, True])
def test_count_params_equals_reference(models, quantized):
    """Elements in the tree, dense and with every projection packed
    ([L, E, K, M] expert stacks included): equal counts."""
    _, jp, _, tp = models
    if quantized:
        jp = j_quantize_tree(jp, JQuantConfig(8, 1, min_features=1))
        tp = quantize_tree(tp, PimQuantConfig(8, 1, min_features=1))
    assert count_params(tp) == j_count_params(jp)


#: the reference's leaves that stay f32 in the port (beside norm gains)
F32_LEAVES = ("g", "router", "conv_w", "conv_b", "A_log", "D", "dt_bias",
              "r_gates", "b_gates")


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m",
                                  "whisper-medium", "llava-next-34b"])
def test_families_registered_with_the_reference_tree(arch):
    """The recurrent, encoder-decoder and frontend families are in the
    port's registry with `config()` and `smoke()` equal to the
    reference's field by field; the port's own `init_lm` at the bf16
    smoke config has the reference's tree of shapes (exact; whisper the
    decoder-only stack the reference's `init_lm` builds), its f32 leaves
    f32 and every other leaf bf16; and `layer_shapes` gives
    `init_layer`'s tree of shapes and dtypes."""
    assert arch in ARCH_IDS
    for smoke in (False, True):
        got = dataclasses.asdict(get_config(arch, smoke=smoke))
        assert ({k: v for k, v in got.items() if k not in PORT_FIELDS}
                == dataclasses.asdict(j_get_config(arch, smoke=smoke)))
        assert all(got[k] == getattr(ModelConfig, k) for k in PORT_FIELDS)
    cfg = get_config(arch, smoke=True)
    jcfg = j_get_config(arch, smoke=True)
    tp = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree.map(
        lambda x: tuple(x.shape),
        jax.eval_shape(lambda k: j_init_lm(k, jcfg), jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda x: tuple(x.shape), tp) == jshapes
    for path, leaf in jax.tree_util.tree_leaves_with_path(tp):
        name = path[-1].key
        want = torch.float32 if name in F32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, (path, leaf.dtype)
    meta = init_layer(cfg, None, torch.device("meta"), torch.bfloat16)
    assert (jax.tree.map(lambda x: (tuple(x.shape), x.dtype), meta)
            == jax.tree.map(lambda x: x, layer_shapes(cfg, torch.bfloat16),
                            is_leaf=lambda x: isinstance(x, tuple)))


# ---------------------------------------------------------------------------
# the FFN blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_plain_mlp_matches_reference(act):
    """granite's plain MLP (GELU, tanh form) within 1e-5."""
    jpar = j_mlp.init_mlp(jax.random.PRNGKey(2), 32, 64)
    tpar = params_from_jax(jax.tree.map(np.asarray, jpar),
                           _f32(get_config("granite-20b", smoke=True)),
                           "cpu")
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(
        np.float32)
    want = np.asarray(j_mlp.mlp(jpar, jnp.asarray(x), act))
    got = t_mlp.mlp(tpar, torch.from_numpy(x), act).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def test_forward_logits_and_moe_aux_match(models):
    """`forward` logits within atol 1e-4, `moe_aux` (the sum of the MoE
    layers' load-balance losses; 0 for a dense stack) within 1e-5."""
    jcfg, jp, cfg, tp = models
    jt, tt = _tokens(cfg.vocab_size, (2, 12), 4)
    jlog, jaux = j_forward(jp, jt, jcfg)
    tlog, taux = forward(tp, tt, cfg, impl="ref")
    _close(tlog, jlog, LOGIT_TOL)
    _close(taux["moe_aux"], jaux["moe_aux"], AUX_TOL)
    assert (float(taux["moe_aux"]) > 0) == bool(cfg.n_experts)


@pytest.mark.parametrize("last_pos", [None, 4])
def test_prefill_and_decode_steps_match(models, last_pos):
    """Dense cache: prompt 10 in a cache of 12, then four decode steps
    (the last two clamped onto row 11, as the reference does); logits
    within atol 1e-4, the K/V caches within 1e-5."""
    jcfg, jp, cfg, tp = models
    jt, tt = _tokens(cfg.vocab_size, (2, 10), 5)
    jlog, jcache = j_prefill(jp, jt, jcfg, 12, last_pos=last_pos)
    tlog, tcache = prefill(tp, tt, cfg, 12, last_pos=last_pos, impl="ref")
    _close(tlog, jlog, LOGIT_TOL)
    for step in range(4):
        jtok, ttok = _tokens(cfg.vocab_size, (2, 1), 6 + step)
        jlog, jcache = j_decode(jp, jtok, jcache, jcfg)
        tlog, tcache = decode_step(tp, ttok, tcache, cfg, impl="ref")
        _close(tlog, jlog, LOGIT_TOL)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key], CACHE_TOL)


def _assert_pools(jpools, tpools, quantized):
    names = ("k_pages", "v_pages", "k_scales", "v_scales")
    for name, a, b in zip(names, jpools, tpools):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if not quantized:
            np.testing.assert_allclose(b, a, **CACHE_TOL, err_msg=name)
        elif name.endswith("pages"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_prefill_and_decode_match(models, kv_dtype):
    """Two slots sharing a page: a full prefill and a prefix-offset chunk
    (start > 0) with pad rows, then three decode steps across a page
    boundary, and a decode with an idle slot (scratch table, position
    0) — its row routes through the experts with the others, as in the
    reference. Logits within atol 1e-4; float pools within 1e-5, int8
    codes equal and scales within rtol 1e-6."""
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(7)
    i32 = lambda x: np.asarray(x, np.int32)
    bt = i32([[3, 7, 1, 9, 11], [5, 2, 12, 4, 14]])
    steps = [("prefill", bt, rng.integers(0, 128, (2, 8)), i32([0, 0]),
              i32([7, 5]), 6),
             ("prefill", bt, rng.integers(0, 128, (2, 8)), i32([7, 5]),
              i32([13, 11]), 5)]
    pos = [13, 11]
    for _ in range(3):
        steps.append(("decode", bt, rng.integers(0, 128, (2, 1)), i32(pos),
                      None, None))
        pos = [p + 1 for p in pos]
    steps.append(("decode", i32([[0] * 5, bt[1]]),
                  rng.integers(0, 128, (2, 1)), i32([0, pos[1]]), None,
                  None))
    nb, bs = 16, 4
    jpools = [jnp.asarray(x) for x in j_init_pool(jcfg, nb, bs, kv_dtype)]
    tpools = list(init_paged_pool(cfg, nb, bs, kv_dtype, device="cpu"))
    quantized = kv_dtype == "int8"
    for kind, table, toks, a, b, last in steps:
        toks = toks.astype(np.int32)
        jsc = dict(k_scales=jpools[2], v_scales=jpools[3]) if quantized \
            else {}
        tsc = dict(k_scales=tpools[2], v_scales=tpools[3]) if quantized \
            else {}
        jbt, tbt = jnp.asarray(table), torch.tensor(table)
        if kind == "prefill":
            jr = j_prefill_paged(jp, jnp.asarray(toks), jpools[0], jpools[1],
                                 jbt, jnp.asarray(a), jnp.asarray(b), jcfg,
                                 last_pos=jnp.asarray(last), impl="ref",
                                 **jsc)
            tr = prefill_paged(tp, torch.tensor(toks), tpools[0], tpools[1],
                               tbt, torch.tensor(a), torch.tensor(b), cfg,
                               last_pos=last, impl="ref", **tsc)
        else:
            jr = j_decode_paged(jp, jnp.asarray(toks), jpools[0], jpools[1],
                                jbt, jnp.asarray(a), jcfg, impl="ref", **jsc)
            tr = decode_step_paged(tp, torch.tensor(toks), tpools[0],
                                   tpools[1], tbt, torch.tensor(a), cfg,
                                   impl="ref", **tsc)
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]),
                                   **LOGIT_TOL)
        jpools, tpools = list(jr[1:]), list(tr[1:])
        _assert_pools(jpools, tpools, quantized)

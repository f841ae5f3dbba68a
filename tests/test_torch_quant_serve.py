"""PIM bit-plane quantized paged serving (`--quantize`) of the PyTorch
port against the JAX reference, on the CPU (qwen2-1.5b smoke, f32).

The reference's own `init_lm` parameters cross through numpy
(`bridge.params_from_jax`), so both packages quantize the same f32
arrays:
  * `quantize_tree` quantizes the same leaves on both sides, with planes
    and scales EXACTLY equal, and `tree_packed_fraction` /
    `ServeEngine.quantize` agree; the reference's quantized tree crosses
    the bridge with its planes uint8 and its scales f32, bit for bit;
  * one quantized paged prefill (two chunks) and decode steps: logits
    within 1e-4 (the port's plain versions against the reference's jnp
    oracles — both unpack and run an f32 matmul);
  * quantized `ContinuousBatcher` drains, prefix index on, for (8, 1)
    and (4, 2) with bf16 KV and (4, 2) with int8 KV: greedy tokens,
    ticks, prefill tokens and pages allocated equal the reference's, and
    so does the step-signature count (`trace_count`);
  * the launcher's `--paged --quantize --device cpu` runs and prints the
    packed-fraction line.
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
from repro.quant.bitplane import PimQuantConfig as JQuantConfig
from repro.quant.bitplane import quantize_tree as j_quantize_tree
from repro.quant.bitplane import tree_packed_fraction as j_packed_fraction
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JEngine
from repro.serve.compiled import trace_count as j_trace_count
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.serve import main as launch_main
from repro_torch.models import (
    decode_step_paged,
    init_paged_pool,
    prefill_paged,
)
from repro_torch.models.transformer import layer_params
from repro_torch.quant import (
    PimQuantConfig,
    PimWeight,
    quantize_tree,
    tree_packed_fraction,
)
from repro_torch.serve import (
    ContinuousBatcher,
    Request,
    ServeConfig,
    ServeEngine,
)
from repro_torch.serve.compiled import trace_count

QUANTIZED = {"attn": ("wk", "wo", "wq", "wv"),
             "mlp": ("w_down", "w_gate", "w_up")}


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(j_get_config("qwen2-1.5b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype="float32")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


_QUANT_CACHE = {}


def _quantized(models, n_bits, group):
    """(reference quantized tree, the port's own quantize_tree of the
    bridged f32 params), memoized per format."""
    key = (n_bits, group)
    if key not in _QUANT_CACHE:
        _, jp, _, tp = models
        jq = j_quantize_tree(jp, JQuantConfig(n_bits, group, min_features=1))
        tq = quantize_tree(tp, PimQuantConfig(n_bits, group, min_features=1))
        _QUANT_CACHE[key] = jq, tq
    return _QUANT_CACHE[key]


def _pim_leaves(tree, path=""):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _pim_leaves(leaf, f"{path}/{name}")
        elif hasattr(leaf, "planes"):
            yield f"{path}/{name}", leaf


@pytest.mark.parametrize("n_bits,group", [(8, 1), (4, 2), (3, 4)])
def test_quantize_tree_matches_reference(models, n_bits, group):
    jcfg, jp, cfg, tp = models
    jq, tq = _quantized(models, n_bits, group)
    jleaves = dict(_pim_leaves(jq))
    tleaves = dict(_pim_leaves(tq))
    assert sorted(tleaves) == sorted(jleaves) == sorted(
        f"/layers/{blk}/{w}" for blk, ws in QUANTIZED.items() for w in ws)
    bridged = params_from_jax(jax.tree.map(np.asarray, jq), cfg, "cpu")
    for path, jw in jleaves.items():
        tw = tleaves[path]
        assert (tw.n_bits, tw.group) == (jw.n_bits, jw.group) == (
            n_bits, group)
        np.testing.assert_array_equal(tw.planes.numpy(), np.asarray(jw.planes))
        np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
        bw = dict(_pim_leaves(bridged))[path]
        assert isinstance(bw, PimWeight)
        assert bw.planes.dtype == torch.uint8
        assert bw.scale.dtype == torch.float32
        assert torch.equal(bw.planes, tw.planes)
        assert torch.equal(bw.scale, tw.scale)
        assert tw.packed_bytes == jw.packed_bytes
    assert tree_packed_fraction(tq) == j_packed_fraction(jq)
    # the engine entry point returns the same fraction
    qcfg = dict(n_bits=n_bits, group=group, min_features=1)
    frac = ServeEngine(cfg, tp, ServeConfig(paged=True, device="cpu")
                       ).quantize(PimQuantConfig(**qcfg))
    assert frac == JEngine(jcfg, jp, JServeConfig()).quantize(
        JQuantConfig(**qcfg))
    # the layer view slices the stacked planes and scale
    lw = layer_params(tq["layers"], 1)["mlp"]["w_up"]
    assert torch.equal(lw.planes, tq["layers"]["mlp"]["w_up"].planes[1])
    assert torch.equal(lw.scale, tq["layers"]["mlp"]["w_up"].scale[1])


@pytest.mark.parametrize("n_bits,group", [(8, 1), (4, 2)])
def test_quantized_prefill_and_decode_logits_match(models, n_bits, group):
    jcfg, _, cfg, _ = models
    jq, tq = _quantized(models, n_bits, group)
    nb, bs = 16, 4
    jk, jv = (jnp.asarray(x) for x in j_init_pool(jcfg, nb, bs))
    tk, tv = init_paged_pool(cfg, nb, bs, device="cpu")
    rng = np.random.default_rng(0)
    i32 = lambda x: np.asarray(x, np.int32)
    bt = i32([[3, 7, 1, 9, 11], [5, 2, 12, 4, 14]])
    jbt, tbt = jnp.asarray(bt), torch.tensor(bt)
    for a, b, last in (([0, 0], [7, 5], 6), ([7, 5], [13, 11], 5)):
        toks = rng.integers(0, 128, (2, 8)).astype(np.int32)
        jr = j_prefill(jq, jnp.asarray(toks), jk, jv, jbt, jnp.asarray(i32(a)),
                       jnp.asarray(i32(b)), jcfg, last_pos=jnp.asarray(last),
                       impl="ref")
        tr = prefill_paged(tq, torch.tensor(toks), tk, tv, tbt,
                           torch.tensor(i32(a)), torch.tensor(i32(b)), cfg,
                           last_pos=last, impl="ref")
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]), rtol=0,
                                   atol=1e-4)
        jk, jv = jr[1:]
    pos = [13, 11]
    for _ in range(2):
        toks = rng.integers(0, 128, (2, 1)).astype(np.int32)
        jr = j_decode(jq, jnp.asarray(toks), jk, jv, jbt,
                      jnp.asarray(i32(pos)), jcfg, impl="ref")
        tr = decode_step_paged(tq, torch.tensor(toks), tk, tv, tbt,
                               torch.tensor(i32(pos)), cfg, impl="ref")
        np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]), rtol=0,
                                   atol=1e-4)
        jk, jv = jr[1:]
        pos = [p + 1 for p in pos]


def _trace():
    """6 requests: a shared 8-token system prompt plus 1-8 own tokens, so
    later requests hit the prefix index and prefill a suffix (start > 0)."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 128, 8).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, 128, int(n)).astype(
        np.int32)]) for n in rng.integers(1, 9, 6)]


def _drain(batcher_cls, request_cls, cfg, params, prompts, to_prompt,
           count, **kw):
    before = count()
    cb = batcher_cls(cfg, params, n_slots=3, cache_len=24, paged=True,
                     block_size=4, prefix=True, **kw)
    for uid, p in enumerate(prompts):
        cb.submit(request_cls(uid=uid, prompt=to_prompt(p),
                              max_new_tokens=5))
    res = cb.run_until_drained()
    pc = cb.pcache
    stats = dict(ticks=cb.ticks, prefill_tokens=cb.prefill_tokens,
                 pages_allocated=pc.pages_allocated, hits=cb.prefix.hits,
                 traces=count() - before)
    pc.check_invariants(cb.prefix.page_refs())
    return {u: list(v) for u, v in res.items()}, stats


@pytest.mark.parametrize("n_bits,group,kv_dtype", [
    (8, 1, "bf16"), (4, 2, "bf16"), (4, 2, "int8")])
def test_quantized_drain_matches_reference(models, n_bits, group, kv_dtype):
    jcfg, _, cfg, _ = models
    jq, tq = _quantized(models, n_bits, group)
    prompts = _trace()
    ref = _drain(JBatcher, JRequest, jcfg, jq, prompts, jnp.asarray,
                 j_trace_count, kv_dtype=kv_dtype)
    port = _drain(ContinuousBatcher, Request, cfg, tq, prompts, lambda p: p,
                  trace_count, kv_dtype=kv_dtype, device="cpu")
    assert port[1] == ref[1]
    assert port[0] == ref[0]
    assert port[1]["hits"] > 0
    assert all(len(v) == 5 for v in port[0].values())


def test_launcher_quantize_on_cpu(capsys):
    launch_main(["--paged", "--quantize", "--device", "cpu", "--prefix",
                 "--requests", "3", "--slots", "2", "--new-tokens", "3",
                 "--bits", "4", "--group", "2"])
    out = capsys.readouterr().out
    assert "PIM-quantized: " in out
    assert "of param bytes packed (4-bit, group=2)" in out
    assert "served 3 requests, 9 tokens" in out

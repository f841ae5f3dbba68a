"""The encoder-decoder backbone (whisper-medium) in the port against the
JAX reference: cross-attention, `encode`, `forward_encdec`,
`prefill_encdec` and `decode_step_encdec`, and `init_encdec`'s tree.

The reference's own `init_encdec` parameters of the smoke config (2 + 2
layers, d 32) cross through numpy (`bridge.params_from_jax`); the stub
frame embeddings and the tokens are numpy arrays from a seed, handed to
both packages. f32.

Tolerances: logits atol 1e-4, every cache entry (self K/V, cross
`xk` / `xv`) and the encoder states atol 1e-5, cross-attention atol
1e-5 (the rules of test_torch_zoo.py); `count_params` and the tree's
shapes equal. With the reference's 8-bit g = 1 bit-plane tree carried
across (the port's plain bit-plane kernels, the reference's jnp oracle)
logits atol 1e-4 and greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as ja
import repro.models.encdec as je
from repro.configs import get_config as j_get_config
from repro.models import count_params as j_count_params
from repro.quant.bitplane import PimQuantConfig as JQuantConfig
from repro.quant.bitplane import quantize_tree as j_quantize_tree
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import (
    count_params,
    decode_step_encdec,
    forward_encdec,
    init_encdec,
    init_encdec_cache,
    prefill_encdec,
)
from repro_torch.models import attention as ta
from repro_torch.models import encdec as te

LOGIT_TOL = dict(rtol=0, atol=1e-4)
STATE_TOL = dict(rtol=0, atol=1e-5)
ARCH = "whisper-medium"


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def whisper():
    jcfg = _f32(j_get_config(ARCH, smoke=True))
    cfg = _f32(get_config(ARCH, smoke=True))
    jp = je.init_encdec(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


def _frames(cfg, b, s, seed):
    f = (0.02 * np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model))).astype(np.float32)
    return jnp.asarray(f), torch.from_numpy(f)


def _tokens(vocab, shape, seed):
    t = np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)
    return jnp.asarray(t), torch.from_numpy(t)


def test_cross_attention_matches_reference(whisper):
    """`cross_attention_kv` and `cross_attention_forward` of the first
    decoder layer: 5 decoder positions over 11 encoder positions, every
    pair visible."""
    jcfg, jp, cfg, tp = whisper
    jx_ = jax.tree.map(lambda a: a[0], jp["dec_layers"]["xattn"])
    tx_ = {k: v[0] for k, v in tp["dec_layers"]["xattn"].items()}
    jenc, tenc = _frames(cfg, 2, 11, 1)
    jdec, tdec = _frames(cfg, 2, 5, 2)
    h, hd = cfg.n_heads, cfg.hd
    jk, jv = ja.cross_attention_kv(jx_, jenc, h, hd)
    tk, tv = ta.cross_attention_kv(tx_, tenc, h, hd)
    _close(tk, jk, STATE_TOL)
    _close(tv, jv, STATE_TOL)
    _close(ta.cross_attention_forward(tx_, tdec, tk, tv, h, hd),
           ja.cross_attention_forward(jx_, jdec, jk, jv, h, hd), STATE_TOL)


def test_init_encdec_tree_and_count_equal_reference(whisper):
    """The port's own `init_encdec` at the bf16 smoke config: the
    reference's tree of shapes, weights bf16, norm gains f32; the
    bridged tree's `count_params` equals the reference's."""
    jcfg, jp, cfg, tp = whisper
    assert count_params(tp) == j_count_params(jp)
    own = init_encdec(get_config(ARCH, smoke=True),
                      torch.Generator().manual_seed(0), "cpu")
    assert (jax.tree.map(lambda x: tuple(x.shape), own)
            == jax.tree.map(lambda x: tuple(x.shape), jp))
    assert own["dec_layers"]["xattn"]["wq"].dtype == torch.bfloat16
    assert own["enc_norm"]["g"].dtype == torch.float32
    # every preallocated leaf was filled: unit gains, drawn weights
    for path, leaf in jax.tree_util.tree_flatten_with_path(own)[0]:
        if path[-1].key == "g":
            assert bool((leaf == 1).all()), path
        else:
            assert bool(torch.isfinite(leaf).all()), path
            assert float(leaf.float().std()) > 0, path
        if leaf.dim() == 3:
            # [L, fan_in, fan_out] projections: cut at 3 sd (bf16-rounded)
            bound = 1.01 * 3 / leaf.shape[1] ** 0.5
            assert float(leaf.float().abs().max()) <= bound, path


@pytest.mark.parametrize("s_enc", [7, 16])
def test_encode_and_forward_encdec_match_reference(whisper, s_enc):
    """The bidirectional encoder's states and the teacher-forced
    decoder's logits (`moe_aux` 0)."""
    jcfg, jp, cfg, tp = whisper
    jf, tf = _frames(cfg, 2, s_enc, s_enc)
    jt, tt = _tokens(cfg.vocab_size, (2, 6), s_enc)
    _close(te.encode(tp, tf, cfg), je.encode(jp, jf, jcfg), STATE_TOL)
    jlog, jaux = je.forward_encdec(jp, jf, jt, jcfg)
    tlog, taux = forward_encdec(tp, tf, tt, cfg, impl="ref")
    _close(tlog, jlog, LOGIT_TOL)
    assert float(taux["moe_aux"]) == float(jaux["moe_aux"]) == 0.0


def test_prefill_and_decode_encdec_match_reference(whisper):
    """`prefill_encdec` over 12 frames and a 4-token decoder prompt
    (logits; `k`, `v`, `xk`, `xv`, position), then six
    `decode_step_encdec`s' logits and caches."""
    jcfg, jp, cfg, tp = whisper
    jf, tf = _frames(cfg, 2, 12, 3)
    jt, tt = _tokens(cfg.vocab_size, (2, 4), 3)
    jlog, jcache = je.prefill_encdec(jp, jf, jt, jcfg, 16)
    tlog, tcache = prefill_encdec(tp, tf, tt, cfg, 16, impl="ref")
    _close(tlog, jlog, LOGIT_TOL)
    assert set(tcache) == set(jcache) == {"position", "k", "v", "xk", "xv"}
    assert tuple(tcache["xk"].shape) == (cfg.n_layers, 2, 12, cfg.n_heads,
                                         cfg.hd)
    for i in range(6):
        for k in ("k", "v", "xk", "xv"):
            _close(tcache[k], jcache[k], STATE_TOL)
        assert tcache["position"] == int(jcache["position"]) == 4 + i
        jt, tt = _tokens(cfg.vocab_size, (2, 1), 20 + i)
        jlog, jcache = je.decode_step_encdec(jp, jt, jcache, jcfg)
        tlog, tcache = decode_step_encdec(tp, tt, tcache, cfg, impl="ref")
        _close(tlog, jlog, LOGIT_TOL)


def test_init_encdec_cache_shapes(whisper):
    jcfg, _, cfg, _ = whisper
    want = je.init_encdec_cache(jcfg, 3, 10, 7)
    got = init_encdec_cache(cfg, 3, 10, 7, "cpu")
    assert got["position"] == 0
    for k in ("k", "v", "xk", "xv"):
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert not got[k].any()


def test_encdec_bitplane_weights_match_reference(whisper):
    """whisper's encoder-decoder with the reference's packed tree:
    `prefill_encdec` over 10 frames and 3 tokens, then four
    `decode_step_encdec`s; logits within 1e-4, greedy tokens equal."""
    jcfg, jp, cfg, _ = whisper
    jq = j_quantize_tree(jp, JQuantConfig(8, 1, min_features=1))
    tq = params_from_jax(jax.tree.map(np.asarray, jq), cfg, "cpu")
    rng = np.random.default_rng(6)
    frames = (0.02 * rng.standard_normal((2, 10, cfg.d_model))).astype(
        np.float32)
    tok = rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    j_prefill = jax.jit(lambda p, f, t: je.prefill_encdec(p, f, t, jcfg, 8))
    j_decode = jax.jit(lambda p, t, c: je.decode_step_encdec(p, t, c, jcfg))
    jlog, jcache = j_prefill(jq, jnp.asarray(frames), jnp.asarray(tok))
    tlog, tcache = prefill_encdec(tq, torch.from_numpy(frames),
                                  torch.from_numpy(tok), cfg, 8)
    for _ in range(4):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=1e-4)
        nxt = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(
            np.int32)
        assert np.array_equal(tlog[:, -1].argmax(-1).numpy()[:, None], nxt)
        jlog, jcache = j_decode(jq, jnp.asarray(nxt), jcache)
        tlog, tcache = decode_step_encdec(tq, torch.from_numpy(nxt), tcache,
                                          cfg)

"""The modality frontend stubs and llava-next-34b in the port against the
JAX reference: `frontend_split`, the stub embeddings, and the llava
stack (56 query heads over 8 kv-heads at full width; the smoke config's
2 over 1) with the stub's patch positions prepended through
`extra_embeds` — `forward`, `prefill` (with `last_pos`) and
`decode_step`.

The reference's own `init_lm` parameters of the smoke config cross
through numpy (`bridge.params_from_jax`). `make_stub_embeddings` draws
from a `torch.Generator`, which cannot give `jax.random`'s numbers, so
both packages get the same numpy embeddings. f32.

Tolerances: logits atol 1e-4 and caches atol 1e-5 (the rules of
test_torch_zoo.py); `frontend_split` exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_lm as j_init_lm
from repro.models import prefill as j_prefill
from repro.models.frontend_stub import frontend_split as j_split
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import decode_step, forward, prefill
from repro_torch.models.frontend_stub import (
    frontend_split,
    make_stub_embeddings,
)

LOGIT_TOL = dict(rtol=0, atol=1e-4)
CACHE_TOL = dict(rtol=0, atol=1e-5)
ARCH = "llava-next-34b"


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("smoke", [True, False])
def test_frontend_split_equals_reference(arch, smoke):
    """(stub positions, text tokens) for several combined lengths."""
    cfg, jcfg = get_config(arch, smoke=smoke), j_get_config(arch,
                                                            smoke=smoke)
    for seq_len in (2, 9, 64, 4096):
        assert frontend_split(cfg, seq_len) == j_split(jcfg, seq_len)


def test_make_stub_embeddings_is_seeded():
    """[B, N, D] f32 at N(0, 0.02), the same for the same seed."""
    cfg = get_config(ARCH, smoke=True)
    a = make_stub_embeddings(cfg, 2, 300, seed=3, device="cpu")
    assert a.shape == (2, 300, cfg.d_model) and a.dtype == torch.float32
    assert torch.equal(a, make_stub_embeddings(cfg, 2, 300, seed=3,
                                               device="cpu"))
    assert abs(float(a.std()) - 0.02) < 0.002


@pytest.fixture(scope="module")
def llava():
    jcfg = dataclasses.replace(j_get_config(ARCH, smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def _inputs(cfg, b, t_text, seed):
    rng = np.random.default_rng(seed)
    n_front, _ = frontend_split(cfg, cfg.frontend_tokens + t_text)
    emb = (0.02 * rng.standard_normal((b, n_front, cfg.d_model))).astype(
        np.float32)
    tok = rng.integers(0, cfg.vocab_size, (b, t_text)).astype(np.int32)
    return (jnp.asarray(emb), jnp.asarray(tok), torch.from_numpy(emb),
            torch.from_numpy(tok))


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def test_llava_forward_with_stub_matches_reference(llava):
    """Logits over the 8 stub positions and 6 text tokens."""
    jcfg, jp, cfg, tp = llava
    je, jt, te, tt = _inputs(cfg, 2, 6, 0)
    jlog, _ = j_forward(jp, jt, jcfg, extra_embeds=je)
    tlog, _ = forward(tp, tt, cfg, extra_embeds=te, impl="ref")
    assert tlog.shape == (2, cfg.frontend_tokens + 6, cfg.vocab_size)
    _close(tlog, jlog, LOGIT_TOL)


@pytest.mark.parametrize("last_pos", [None, 5, 11])
def test_llava_prefill_and_decode_with_stub_match_reference(llava,
                                                            last_pos):
    """`prefill` of the stub positions and the text (logits at `last_pos`
    of the combined sequence; K/V; position 14), then five
    `decode_step`s."""
    jcfg, jp, cfg, tp = llava
    je, jt, te, tt = _inputs(cfg, 2, 6, 1)
    jlog, jcache = j_prefill(jp, jt, jcfg, 20, extra_embeds=je,
                             last_pos=last_pos)
    tlog, tcache = prefill(tp, tt, cfg, 20, extra_embeds=te,
                           last_pos=last_pos, impl="ref")
    _close(tlog, jlog, LOGIT_TOL)
    assert tcache["position"] == int(jcache["position"]) == 14
    for i in range(5):
        _close(tcache["k"], jcache["k"], CACHE_TOL)
        _close(tcache["v"], jcache["v"], CACHE_TOL)
        tok = np.full((2, 1), 7 + i, np.int32)
        jlog, jcache = j_decode(jp, jnp.asarray(tok), jcache, jcfg)
        tlog, tcache = decode_step(tp, torch.from_numpy(tok), tcache, cfg,
                                   impl="ref")
        _close(tlog, jlog, LOGIT_TOL)

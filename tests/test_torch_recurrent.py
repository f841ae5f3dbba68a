"""The recurrent families in the port against the JAX reference: the
Mamba2 (SSD) block and zamba2-1.2b's stack (Mamba2 layers with one
weight-shared attention block after every `attn_every`-th), the mLSTM
and sLSTM cells and xlstm-350m's stack.

The reference's own parameters (its `init_mamba2` / `init_mlstm` /
`init_slstm` for the blocks, `init_lm` of the smoke configs for the
stacks) cross through numpy (`bridge.params_from_jax`); inputs are numpy
arrays from a seed. The reference runs its jnp paths (there is no
Pallas kernel in these blocks), the port its plain torch ops, in f32.

Tolerances: block outputs and states atol 1e-5; logits atol 1e-4 and
every cache entry atol 1e-5 (the rules of test_torch_zoo.py); the
reference's own block properties (test_blocks.py) at its tolerances:
chunked SSD against the recurrence and across chunk sizes 2e-2, the
cells' forward against their decode loops 1e-4; teacher-forced decode
against `forward` at test_models.py's 3e-2. bf16 decode of a bridged
block within 2e-2 of the reference's bf16 decode (bf16 rounds at other
places in the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba2 as jm
import repro.models.xlstm as jx
from repro.configs import get_config as j_get_config
from repro.models import count_params as j_count_params
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_lm as j_init_lm
from repro.models import prefill as j_prefill
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import (
    count_params,
    decode_step,
    forward,
    init_lm,
    prefill,
)
from repro_torch.models import mamba2 as tm
from repro_torch.models import xlstm as tx

KEY = jax.random.PRNGKey(0)
BLOCK_TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
CACHE_TOL = dict(rtol=0, atol=1e-5)
#: the reference's f32 leaves of these families
F32_LEAVES = {"mamba": ("conv_w", "conv_b", "A_log", "D", "dt_bias"),
              "slstm": ("r_gates", "b_gates")}


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _bridge(tree, dtype=torch.float32):
    cfg = get_config("zamba2-1.2b", smoke=True)
    return params_from_jax(jax.tree.map(np.asarray, tree), cfg, "cpu",
                           dtype=dtype)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), **tol)


def _x(shape, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

D, H, N, DI = 16, 4, 8, 32
SSM = dict(n_heads=H, n_state=N, d_inner=DI)


@pytest.fixture(scope="module")
def mamba():
    jp = jm.init_mamba2(KEY, D, DI, H, N)
    return jp, _bridge(jp)


@pytest.mark.parametrize("t,chunk,carried", [
    (1, 4, False), (2, 4, False), (12, 4, False), (13, 4, False),
    (37, 8, True), (16, 16, True)])
def test_mamba2_forward_matches_reference(mamba, t, chunk, carried):
    """Output, last state and conv tail: T below the conv width (a
    zero-padded tail), T not a multiple of the chunk (padded chunks),
    and a carried `init_state`."""
    jp, tp = mamba
    u = _x((2, t, D), t)
    h0 = _x((2, H, DI // H, N), 100 + t, 0.1) if carried else None
    want, (wh, wtail) = jm.mamba2_forward(
        jp, jnp.asarray(u), chunk=chunk, return_state=True,
        init_state=None if h0 is None else jnp.asarray(h0), **SSM)
    got, (gh, gtail) = tm.mamba2_forward(
        tp, torch.from_numpy(u), chunk=chunk, return_state=True,
        init_state=None if h0 is None else torch.from_numpy(h0), **SSM)
    _close(got, want, BLOCK_TOL)
    _close(gh, wh, BLOCK_TOL)
    _close(gtail, wtail, BLOCK_TOL)
    assert tuple(gtail.shape) == (2, 3, tm.conv_dim(DI, N))


def test_mamba2_decode_matches_reference(mamba):
    """Six decode steps from a random state and conv tail: outputs,
    states and tails."""
    jp, tp = mamba
    st = _x((2, H, DI // H, N), 7, 0.1)
    cv = _x((2, 3, tm.conv_dim(DI, N)), 8)
    js, jc = jnp.asarray(st), jnp.asarray(cv)
    ts, tc = torch.from_numpy(st), torch.from_numpy(cv)
    for i in range(6):
        u = _x((2, 1, D), 20 + i)
        wy, js, jc = jm.mamba2_decode(jp, jnp.asarray(u), js, jc, **SSM)
        gy, ts, tc = tm.mamba2_decode(tp, torch.from_numpy(u), ts, tc, **SSM)
        _close(gy, wy, BLOCK_TOL)
        _close(ts, js, BLOCK_TOL)
        _close(tc, jc, BLOCK_TOL)


def test_mamba2_chunked_matches_recurrent(mamba):
    """The reference's property, in the port: chunked SSD forward ==
    step-by-step decode (2e-2)."""
    _, tp = mamba
    u = torch.from_numpy(_x((2, 12, D), 3))
    y = tm.mamba2_forward(tp, u, chunk=4, **SSM)
    st = torch.zeros((2, H, DI // H, N))
    cv = torch.zeros((2, 3, tm.conv_dim(DI, N)))
    outs = []
    for t in range(12):
        o, st, cv = tm.mamba2_decode(tp, u[:, t: t + 1], st, cv, **SSM)
        outs.append(o)
    torch.testing.assert_close(y, torch.cat(outs, 1), rtol=2e-2, atol=2e-2)


def test_mamba2_chunk_size_invariance(mamba):
    _, tp = mamba
    u = torch.from_numpy(_x((1, 16, D), 4))
    torch.testing.assert_close(tm.mamba2_forward(tp, u, chunk=4, **SSM),
                               tm.mamba2_forward(tp, u, chunk=16, **SSM),
                               rtol=2e-2, atol=2e-2)


def test_mamba2_bf16_decode_keeps_f32_leaves(mamba):
    """bf16 decode with bridged parameters stays within 2e-2 of the
    reference's bf16 decode: the conv is an f32 contraction with the f32
    `conv_w`, which the bridge keeps f32 (a bf16 `conv_w` would move
    it)."""
    jp, _ = mamba
    tp = _bridge(jp, torch.bfloat16)
    for name in F32_LEAVES["mamba"]:
        assert tp[name].dtype == torch.float32, name
    assert tp["w_in"].dtype == torch.bfloat16
    st = _x((2, H, DI // H, N), 9, 0.1)
    cv = _x((2, 3, tm.conv_dim(DI, N)), 10)
    u = _x((2, 1, D), 11)
    wy, ws, _ = jm.mamba2_decode(jp, jnp.asarray(u, jnp.bfloat16),
                                 jnp.asarray(st),
                                 jnp.asarray(cv, jnp.bfloat16), **SSM)
    gy, gs, _ = tm.mamba2_decode(tp, torch.from_numpy(u).bfloat16(),
                                 torch.from_numpy(st),
                                 torch.from_numpy(cv).bfloat16(), **SSM)
    _close(gy, wy, dict(rtol=0, atol=2e-2))
    _close(gs, ws, dict(rtol=0, atol=2e-2))


# ---------------------------------------------------------------------------
# the mLSTM and sLSTM cells
# ---------------------------------------------------------------------------

XD, XH = 16, 2


@pytest.fixture(scope="module")
def cells():
    jmp, jsp = jx.init_mlstm(KEY, XD, XH), jx.init_slstm(KEY, XD, XH)
    return jmp, _bridge(jmp), jsp, _bridge(jsp)


def _states_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], BLOCK_TOL)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
@pytest.mark.parametrize("carried", [False, True])
def test_cell_forward_matches_reference(cells, cell, carried):
    """The cell's forward over 10 steps, from its initial state or from
    the state a first 5-step forward left: outputs and states."""
    jmp, tmp, jsp, tsp = cells
    jp, tp = (jmp, tmp) if cell == "mlstm" else (jsp, tsp)
    jfwd, tfwd = ((jx.mlstm_forward, tx.mlstm_forward) if cell == "mlstm"
                  else (jx.slstm_forward, tx.slstm_forward))
    jst = tst = None
    if carried:
        x0 = _x((2, 5, XD), 30)
        _, jst = jfwd(jp, jnp.asarray(x0), n_heads=XH, return_state=True)
        _, tst = tfwd(tp, torch.from_numpy(x0), n_heads=XH,
                      return_state=True)
    x = _x((2, 10, XD), 31)
    wy, ws = jfwd(jp, jnp.asarray(x), n_heads=XH, init_state=jst,
                  return_state=True)
    gy, gs = tfwd(tp, torch.from_numpy(x), n_heads=XH, init_state=tst,
                  return_state=True)
    _close(gy, wy, BLOCK_TOL)
    _states_close(gs, ws)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_decode_matches_reference(cells, cell):
    """Eight decode steps from the initial state: outputs and states."""
    jmp, tmp, jsp, tsp = cells
    if cell == "mlstm":
        jp, tp, jdec, tdec = jmp, tmp, jx.mlstm_decode, tx.mlstm_decode
        jst = jx.mlstm_init_state(2, XH, 2 * XD // XH)
        tst = tx.mlstm_init_state(2, XH, 2 * XD // XH, "cpu")
    else:
        jp, tp, jdec, tdec = jsp, tsp, jx.slstm_decode, tx.slstm_decode
        jst, tst = jx.slstm_init_state(2, XD), tx.slstm_init_state(2, XD,
                                                                  "cpu")
    _states_close(tst, jst)
    for i in range(8):
        x = _x((2, 1, XD), 40 + i)
        wy, jst = jdec(jp, jnp.asarray(x), jst, n_heads=XH)
        gy, tst = tdec(tp, torch.from_numpy(x), tst, n_heads=XH)
        _close(gy, wy, BLOCK_TOL)
        _states_close(tst, jst)


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cell_forward_matches_its_decode_loop(cells, cell):
    """The reference's property, in the port (1e-4)."""
    _, tmp, _, tsp = cells
    x = torch.from_numpy(_x((2, 10, XD), 5))
    if cell == "mlstm":
        tp, fwd, dec = tmp, tx.mlstm_forward, tx.mlstm_decode
        st = tx.mlstm_init_state(2, XH, 2 * XD // XH, "cpu")
    else:
        tp, fwd, dec = tsp, tx.slstm_forward, tx.slstm_decode
        st = tx.slstm_init_state(2, XD, "cpu")
    outs = []
    for t in range(10):
        y, st = dec(tp, x[:, t: t + 1], st, n_heads=XH)
        outs.append(y)
    torch.testing.assert_close(fwd(tp, x, n_heads=XH), torch.cat(outs, 1),
                               rtol=1e-4, atol=1e-4)


def test_mlstm_init_draws_wf_equal_to_wi():
    """The reference draws `wi` and `wf` from one key; the port's init
    keeps them equal too, and the sLSTM's `r_gates` / `b_gates` f32."""
    m = tx.init_mlstm(XD, XH, 2, torch.Generator().manual_seed(0), "cpu",
                      torch.bfloat16)
    assert torch.equal(m["wi"], m["wf"]) and m["wi"].dtype == torch.bfloat16
    s = tx.init_slstm(XD, XH, torch.Generator().manual_seed(0), "cpu",
                      torch.bfloat16)
    assert s["r_gates"].dtype == s["b_gates"].dtype == torch.float32
    assert abs(float(s["r_gates"].std()) - 0.1) < 0.03


# ---------------------------------------------------------------------------
# the stacks: zamba2-1.2b and xlstm-350m
# ---------------------------------------------------------------------------

#: (arch, layers): the smoke configs, and zamba2 at 5 layers, whose last
#: group is a 1-layer tail with no shared block
STACKS = [("zamba2-1.2b", None), ("zamba2-1.2b", 5), ("xlstm-350m", None)]


@pytest.fixture(scope="module", params=STACKS,
                ids=[f"{a}-{n or 'smoke'}" for a, n in STACKS])
def stack(request):
    arch, layers = request.param
    jcfg = _f32(j_get_config(arch, smoke=True))
    cfg = _f32(get_config(arch, smoke=True))
    if layers:
        jcfg = dataclasses.replace(jcfg, n_layers=layers)
        cfg = dataclasses.replace(cfg, n_layers=layers)
    jp = j_init_lm(KEY, jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, tp


def _tokens(vocab, shape, seed):
    t = np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)
    return jnp.asarray(t), torch.from_numpy(t)


@pytest.mark.parametrize("t", [13, 300])
def test_stack_forward_matches_reference(stack, t):
    """`forward` logits (T = 300 spans two 256-step SSD chunks) and
    `moe_aux` (0), and `count_params`, equal."""
    jcfg, jp, cfg, tp = stack
    jt, tt = _tokens(cfg.vocab_size, (2, t), t)
    jlog, jaux = j_forward(jp, jt, jcfg)
    tlog, taux = forward(tp, tt, cfg, impl="ref")
    _close(tlog, jlog, LOGIT_TOL)
    assert float(taux["moe_aux"]) == float(jaux["moe_aux"]) == 0.0
    assert count_params(tp) == j_count_params(jp)


@pytest.mark.parametrize("last_pos", [None, 4])
def test_stack_prefill_and_decode_match_reference(stack, last_pos):
    """`prefill` (with `last_pos`) logits and every cache entry — SSM
    states, conv tails, the shared block's K/V, both xLSTM cells' states
    — then six `decode_step`s' logits and caches."""
    jcfg, jp, cfg, tp = stack
    jt, tt = _tokens(cfg.vocab_size, (2, 9), 1)
    jlog, jcache = j_prefill(jp, jt, jcfg, 16, last_pos=last_pos)
    tlog, tcache = prefill(tp, tt, cfg, 16, last_pos=last_pos, impl="ref")
    _close(tlog, jlog, LOGIT_TOL)
    keys = {"mamba": {"position", "ssm", "conv", "shared_k", "shared_v"},
            "xlstm": {"position", "C", "n", "m", "sc", "sn", "sm", "sh"}}
    assert set(tcache) == set(jcache) == keys[cfg.block_kind]
    for i in range(6):
        for k in jcache:
            if k != "position":
                _close(tcache[k], jcache[k], CACHE_TOL)
        assert tcache["position"] == int(jcache["position"]) == 9 + i
        jt, tt = _tokens(cfg.vocab_size, (2, 1), 10 + i)
        jlog, jcache = j_decode(jp, jt, jcache, jcfg)
        tlog, tcache = decode_step(tp, tt, tcache, cfg, impl="ref")
        _close(tlog, jlog, LOGIT_TOL)


def test_stack_decode_matches_forward_teacher_forcing(stack):
    """The reference's property (test_models.py), in the port: prefill
    half the tokens, feed the rest one by one; every step's logits equal
    `forward`'s at that position (3e-2)."""
    _, _, cfg, tp = stack
    _, tt = _tokens(cfg.vocab_size, (2, 12), 2)
    full, _ = forward(tp, tt, cfg)
    lp, cache = prefill(tp, tt[:, :6], cfg, 14)
    torch.testing.assert_close(lp[:, -1], full[:, 5], rtol=3e-2, atol=3e-2)
    for i in range(6, 12):
        ld, cache = decode_step(tp, tt[:, i: i + 1], cache, cfg)
        torch.testing.assert_close(ld[:, 0], full[:, i], rtol=3e-2,
                                   atol=3e-2)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m"])
def test_f32_leaves_stay_f32(arch):
    """At a bf16 config the reference's f32 leaves stay f32 after the
    bridge and in the port's own `init_lm`; the projections are bf16."""
    cfg = get_config(arch, smoke=True)
    jp = j_init_lm(KEY, j_get_config(arch, smoke=True))
    for tp in (params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu"),
               init_lm(cfg, torch.Generator().manual_seed(0), "cpu")):
        layers = tp["layers"]
        if arch == "zamba2-1.2b":
            for name in F32_LEAVES["mamba"]:
                assert layers["mamba"][name].dtype == torch.float32, name
            assert layers["mamba"]["w_in"].dtype == torch.bfloat16
            assert tp["shared"]["attn"]["wq"].dtype == torch.bfloat16
        else:
            for name in F32_LEAVES["slstm"]:
                assert layers["slstm"][name].dtype == torch.float32, name
            assert layers["mlstm"]["wi"].dtype == torch.bfloat16
        assert layers["ln1"]["g"].dtype == torch.float32

"""The port's mixture-of-experts layer against the JAX reference.

The reference's own `init_moe` draws the parameters, which cross
through numpy (`bridge.params_from_jax`, router kept f32); the same
numpy inputs then go through both `moe_forward`s in f32, the port's
bit-plane experts through its plain kernels and the reference's
through its jnp oracle (`impl="auto"` off the TPU).

Tolerances: `y` and `load_balance_loss` within atol 1e-5 (the two
frameworks' matmuls round differently in the last bits);
`dropped_fraction` EXACTLY equal, since it counts routing decisions and
a single different decision would change it. Packed expert stacks: the
port's `quantize_tree` planes equal the reference's byte for byte and
its scales bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as j_moe
from repro.quant.bitplane import PimQuantConfig as JPimQuantConfig
from repro.quant.bitplane import PimWeight as JPimWeight
from repro.quant.bitplane import quantize_tree as j_quantize_tree
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.common import ACTS
from repro_torch.quant import PimQuantConfig, PimWeight, quantize_tree

TOL = dict(rtol=0, atol=1e-5)
D, F = 32, 64

#: (name, E, top_k, shared, B, T, chunk, capacity factor, zero rows)
CASES = [
    ("top2-chunked", 4, 2, 0, 2, 8, 8, 1.25, 0),
    ("top1-shared-padded", 4, 1, 1, 2, 7, 8, 1.25, 0),
    ("top2-shared-drops", 4, 2, 1, 3, 8, 16, 0.5, 0),
    ("top1-drops-padded", 8, 1, 0, 1, 21, 8, 0.6, 0),
    ("top2-zero-rows-ties", 4, 2, 0, 2, 8, 16, 1.25, 5),
    ("top1-decode-8-slots", 16, 1, 1, 8, 1, 2048, 1.25, 0),
    ("top2-decode-8-slots", 16, 2, 0, 8, 1, 2048, 1.25, 0),
]


def _f32(cfg_arch="phi3.5-moe-42b-a6.6b"):
    return dataclasses.replace(get_config(cfg_arch, smoke=True),
                               dtype="float32")


def _params(e, shared, seed=0):
    jp = j_moe.init_moe(jax.random.PRNGKey(seed), D, F, e, n_shared=shared)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), _f32(), "cpu")


def _x(b, t, zero_rows, seed=1):
    x = np.random.default_rng(seed).standard_normal((b, t, D)).astype(
        np.float32)
    flat = x.reshape(b * t, D)
    flat[1: 1 + zero_rows] = 0.0     # rows whose probabilities all tie
    return x


def _both(jp, tp, x, top_k, chunk, factor, act="silu"):
    jy, jaux = j_moe.moe_forward(jp, jnp.asarray(x), top_k=top_k,
                                 capacity_factor=factor, act=act, chunk=chunk)
    ty, taux = moe.moe_forward(tp, torch.from_numpy(x), top_k=top_k,
                               capacity_factor=factor, act=act, chunk=chunk,
                               impl="ref")
    return (np.asarray(jy), {k: np.asarray(v) for k, v in jaux.items()},
            ty.numpy(), {k: v.numpy() for k, v in taux.items()})


def _assert_match(jy, jaux, ty, taux):
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(taux["load_balance_loss"],
                               jaux["load_balance_loss"], **TOL)
    assert taux["dropped_fraction"] == jaux["dropped_fraction"]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_forward_matches_reference(case):
    """y and the load-balance loss within 1e-5, the dropped fraction
    equal: top-1 and top-2, with and without a shared expert, n a
    multiple of the chunk and not, drops, all-zero rows (uniform
    probabilities, so the top-k order among ties decides), and the
    decode tick's 8 rows at the full chunk (2 places an expert for
    phi3.5's E = 16, top-2; 1 for llama4's top-1)."""
    name, e, top_k, shared, b, t, chunk, factor, zero_rows = case
    jp, tp = _params(e, shared)
    jy, jaux, ty, taux = _both(jp, tp, _x(b, t, zero_rows), top_k, chunk,
                               factor)
    _assert_match(jy, jaux, ty, taux)
    if "drops" in name:
        assert taux["dropped_fraction"] > 0


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_forward_activation(act):
    """The expert activation follows `act` (llama4 and phi3.5 use silu;
    gelu is the tanh form, as `jax.nn.gelu`): within 1e-5."""
    jp, tp = _params(4, 1, seed=3)
    _assert_match(*_both(jp, tp, _x(2, 8, 0, seed=4), 2, 16, 1.25, act))


def test_route_breaks_ties_by_lowest_index():
    """Equal probabilities select the lower expert index first, as
    `jax.lax.top_k` does; the gates are renormalised over the top-k."""
    logits = torch.tensor([[0.0, 0.0, 0.0, 0.0], [1.0, 3.0, 3.0, 1.0],
                           [2.0, 0.0, 2.0, 2.0]])
    gates, idx, probs = moe._route(logits, 2)
    jg, ji, jpr = j_moe._route(jnp.asarray(logits.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 2],
                                                       [0, 2]]
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jpr), rtol=0,
                               atol=1e-7)


def test_capacity_drops_follow_token_order():
    """A chunk whose tokens all pick one expert keeps the first
    `capacity` of them and drops the rest — the reference's priority:
    y within 1e-5 (dropped rows exactly 0), dropped fraction equal."""
    e, b, t = 4, 1, 8
    jp, tp = _params(e, 0)
    router = np.zeros((D, e), np.float32)
    router[:, 2] = 1.0                     # every positive row -> expert 2
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.abs(_x(b, t, 0, seed=5))
    jy, jaux, ty, taux = _both(jp, tp, x, 1, 8, 1.0)
    _assert_match(jy, jaux, ty, taux)
    # capacity ceil(8 * 1 / 4 * 1.0) = 2: rows 2..7 dropped
    assert float(taux["dropped_fraction"]) == 0.75
    assert np.all(ty[0, 2:] == 0.0) and np.all(np.abs(ty[0, :2]) > 0)


@pytest.mark.parametrize("n_bits,group", [(8, 1), (4, 2)])
def test_moe_bitplane_experts_match_reference(n_bits, group):
    """Expert stacks [L, E, K, M] (and the shared expert) packed by the
    reference's `quantize_tree` cross the bridge byte for byte, equal the
    port's own packing of the same f32 stacks, and `moe_forward` through
    the bit-plane experts matches the reference within 1e-5 (dropped
    fraction equal)."""
    e = 4
    jl = [j_moe.init_moe(jax.random.PRNGKey(s), D, F, e, n_shared=1)
          for s in (0, 1)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *jl)
    jq = j_quantize_tree(jstack, JPimQuantConfig(n_bits=n_bits, group=group,
                                                 min_features=8))
    assert isinstance(jq["we_gate"], JPimWeight)
    cfg = _f32()
    tq = params_from_jax(jax.tree.map(np.asarray, jq), cfg, "cpu")
    own = quantize_tree(
        params_from_jax(jax.tree.map(np.asarray, jstack), cfg, "cpu"),
        PimQuantConfig(n_bits=n_bits, group=group, min_features=8,
                       impl="ref"))
    for name in ("we_gate", "we_up", "we_down"):
        w, o = tq[name], own[name]
        assert isinstance(w, PimWeight) and isinstance(o, PimWeight)
        assert tuple(w.planes.shape[:2]) == (2, e)
        assert torch.equal(w.planes, o.planes)
        assert torch.equal(w.scale, o.scale)
        assert w[1][3].shape == ((F, D) if name == "we_down" else (D, F))
    assert isinstance(tq["shared"]["w_gate"], PimWeight)
    assert tq["router"].dtype == torch.float32
    for l in (0, 1):
        jp = jax.tree.map(lambda a: a[l], jq)
        tp = {k: (v[l] if not isinstance(v, dict)
                  else {kk: vv[l] for kk, vv in v.items()})
              for k, v in tq.items()}
        _assert_match(*_both(jp, tp, _x(2, 8, 3, seed=6 + l), 2, 16, 0.75))


def test_gelu_is_the_tanh_form():
    """`ACTS["gelu"]` is `jax.nn.gelu`'s default tanh approximation:
    within 1e-6 over [-8, 8]; the erf form differs by more."""
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = ACTS["gelu"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4

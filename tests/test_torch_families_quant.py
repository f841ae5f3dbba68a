"""The --quantize path of the rest of the model zoo in the port against
the JAX reference: zamba2-1.2b, xlstm-350m, llava-next-34b and
whisper-medium (its `init_lm` stack, which the launcher builds, and its
encoder-decoder tree).

With `min_features=1` every `w*` leaf packs — xLSTM's `wi` / `wf` ([D ->
H], K3 at M = H), the sLSTM weights of layers that run the mLSTM, the
Mamba2 `w_in` / `w_out`, zamba2's shared block, the cross-attention —
while `conv_w`, `r_gates` and the other non-`w` leaves stay dense. The
reference's `quantize_tree` (8-bit, g = 1) and the port's, on the same
f32 parameters (carried across by `bridge.params_from_jax`), give
planes and scales that are EQUAL bit for bit; then the reference's
packed tree crosses the bridge and dense `generate` runs both packages
— the port's plain bit-plane kernels, the reference's jnp oracle
(whisper's encoder-decoder with packed weights: test_torch_encdec.py).

Tolerances: planes and scales exactly equal, greedy f32 tokens equal.
(The reference's quantized jitted steps compile slowly on the CPU.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.encdec as je
from repro.configs import get_config as j_get_config
from repro.models import init_lm as j_init_lm
from repro.quant.bitplane import PimQuantConfig as JQuantConfig
from repro.quant.bitplane import quantize_tree as j_quantize_tree
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.quant import PimQuantConfig, PimWeight, quantize_tree
from repro_torch.serve import ServeConfig, ServeEngine

FAMILIES = ["zamba2-1.2b", "xlstm-350m", "llava-next-34b", "whisper-medium"]
#: leaves that must stay dense, by family
DENSE = {"zamba2-1.2b": ("conv_w", "conv_b", "A_log", "D", "dt_bias"),
         "xlstm-350m": ("r_gates", "b_gates")}


def _cfgs(arch):
    return (dataclasses.replace(j_get_config(arch, smoke=True),
                                dtype="float32"),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32"))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _assert_packed_equal(jq, tq):
    """Every packed leaf of the reference's tree is packed in the port's
    with equal planes, scale, n_bits and group; every dense one stays
    dense. Returns the packed leaves' paths."""
    jl, tl = dict(_leaves(jq)), dict(_leaves(tq))
    assert sorted(jl) == sorted(tl)
    packed = []
    for path, j in jl.items():
        t = tl[path]
        if hasattr(j, "planes"):
            assert isinstance(t, PimWeight), path
            np.testing.assert_array_equal(t.planes.numpy(),
                                          np.asarray(j.planes))
            np.testing.assert_array_equal(t.scale.numpy(),
                                          np.asarray(j.scale))
            assert (t.n_bits, t.group) == (j.n_bits, j.group)
            packed.append(path)
        else:
            assert not isinstance(t, PimWeight), path
    return packed


@pytest.mark.parametrize("arch", FAMILIES)
def test_quantize_tree_planes_equal_reference(arch):
    """`init_lm`'s tree: planes and scales bit-equal; every `w*` leaf
    packed (xLSTM's [D -> H] gates included), the f32 leaves dense."""
    jcfg, cfg = _cfgs(arch)
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    jq = j_quantize_tree(jp, JQuantConfig(8, 1, min_features=1))
    tq = quantize_tree(tp, PimQuantConfig(8, 1, min_features=1))
    packed = _assert_packed_equal(jq, tq)
    names = {p.rsplit("/", 1)[1] for p in packed}
    assert all(n.startswith("w") for n in names)
    assert names == {p.rsplit("/", 1)[1] for p, _ in _leaves(tp)
                     if p.rsplit("/", 1)[1].startswith("w")}
    for name in DENSE.get(arch, ()):
        sub = "mamba" if arch == "zamba2-1.2b" else "slstm"
        assert isinstance(tq["layers"][sub][name], torch.Tensor), name
    if arch == "xlstm-350m":
        assert tq["layers"]["mlstm"]["wi"].shape == (cfg.d_model,
                                                     cfg.n_heads)


def test_quantize_encdec_tree_planes_equal_reference():
    """`init_encdec`'s tree (encoder, decoder, cross-attention):
    planes and scales bit-equal."""
    jcfg, cfg = _cfgs("whisper-medium")
    jp = je.init_encdec(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    packed = _assert_packed_equal(
        j_quantize_tree(jp, JQuantConfig(8, 1, min_features=1)),
        quantize_tree(tp, PimQuantConfig(8, 1, min_features=1)))
    assert "/dec_layers/xattn/wq" in packed and "/enc_layers/mlp/w_up" in packed


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m",
                                  "whisper-medium"])
def test_dense_generate_bitplane_weights_matches_reference(arch):
    """The launcher's --quantize path on the dense cache: the
    reference's packed tree crosses the bridge; dense `generate` of 3
    prompts of 8 tokens, 5 new, gives equal tokens."""
    jcfg, cfg = _cfgs(arch)
    jq = j_quantize_tree(j_init_lm(jax.random.PRNGKey(0), jcfg),
                         JQuantConfig(8, 1, min_features=1))
    tq = params_from_jax(jax.tree.map(np.asarray, jq), cfg, "cpu")
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (3, 8)).astype(np.int32)
    sc = dict(max_cache_len=16, max_new_tokens=5)
    ref = JEngine(jcfg, jq, JServeConfig(**sc)).generate(jnp.asarray(prompts))
    port = ServeEngine(cfg, tq, ServeConfig(device="cpu", **sc)).generate(
        prompts)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))

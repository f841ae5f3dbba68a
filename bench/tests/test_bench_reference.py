"""The benchmark's plain reference agrees with the port on the CPU at smoke
size: dense weights, and the port's 8-bit bit-plane weights against the
reference quantizing them itself."""

import dataclasses

import pytest
import torch

from bench.system import load_family
from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward
from repro_torch.quant.bitplane import PimQuantConfig, quantize_tree

FAMILY = load_family("dense_decoder")

SMOKE = {
    "qwen-like": {"name": "q", "family": "dense", "n_layers": 2,
                  "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 96,
                  "vocab_size": 200, "qkv_bias": True,
                  "tie_embeddings": False, "rope_theta": 1e6,
                  "norm_eps": 1e-5, "act": "silu", "mlp_kind": "swiglu",
                  "dtype": "float32"},
    "granite-like": {"name": "g", "family": "dense", "n_layers": 3,
                     "d_model": 64, "n_heads": 8, "n_kv_heads": 1,
                     "d_ff": 128, "vocab_size": 160, "qkv_bias": False,
                     "tie_embeddings": False, "rope_theta": 1e4,
                     "norm_eps": 1e-5, "act": "gelu", "mlp_kind": "plain",
                     "dtype": "float32"},
}


@pytest.mark.parametrize("arch", sorted(SMOKE))
@pytest.mark.parametrize("pim8", [False, True])
def test_reference_matches_port(arch, pim8):
    model = SMOKE[arch]
    cfg = dataclasses.replace(ModelConfig(**model), remat=False)
    params = FAMILY.make_params(model, 1234, "cpu")
    tokens = torch.randint(0, model["vocab_size"], (37,),
                           generator=torch.Generator().manual_seed(3))
    if pim8:
        served = quantize_tree(params, PimQuantConfig(
            n_bits=8, group=1, impl="ref", min_features=1))
    else:
        served = params
    with torch.no_grad():
        want = forward(served, tokens[None], cfg, impl="ref")[0][0]
    got = FAMILY.reference_logits(params, model, [tokens], [0],
                                  served="int8" if pim8 else None)[0]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want.float(), atol=2e-5, rtol=2e-5)


def test_reference_from_a_start_position():
    model = SMOKE["qwen-like"]
    params = FAMILY.make_params(model, 5, "cpu")
    seq = torch.arange(20) % model["vocab_size"]
    full = FAMILY.reference_logits(params, model, [seq], [0])[0]
    tail = FAMILY.reference_logits(params, model, [seq, seq[:9]], [12, 3])
    torch.testing.assert_close(tail[0], full[12:])
    torch.testing.assert_close(tail[1], full[3:9])


def test_weights_repeat_for_a_seed():
    model = SMOKE["granite-like"]
    a = FAMILY.make_params(model, 77, "cpu")
    b = FAMILY.make_params(model, 77, "cpu")
    c = FAMILY.make_params(model, 78, "cpu")
    assert torch.equal(a["layers"]["mlp"]["w_up"], b["layers"]["mlp"]["w_up"])
    assert not torch.equal(a["embed"], c["embed"])

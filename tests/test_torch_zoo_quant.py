"""The --quantize path of the rest of the attention model zoo
(qwen2.5-14b, granite-20b, phi3.5-moe-42b-a6.6b, llama4-scout-17b-a16e)
in the port against the JAX reference: the reference's `quantize_tree`
(8-bit, g = 1, every projection of the smoke model packed, the MoE
expert stacks [L, E, K, M] and the shared expert included) crosses the
bridge, and paged `ServeEngine.generate` runs both packages — the
port's bit-plane experts one expert at a time through its plain
kernels, the reference's through its jnp oracle.

Tolerance: none — greedy f32 tokens are EQUAL. (The reference's
quantized jitted steps compile slowly on the CPU: ~15-25 s a model.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import init_lm as j_init_lm
from repro.quant.bitplane import PimQuantConfig as JQuantConfig
from repro.quant.bitplane import quantize_tree as j_quantize_tree
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JEngine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.quant import PimWeight
from repro_torch.serve import ServeConfig, ServeEngine


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "granite-20b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "llama4-scout-17b-a16e"])
def test_engine_generate_bitplane_weights_matches_reference(arch):
    """The --quantize path: the reference's `quantize_tree` (8-bit,
    g = 1, every projection and expert stack of the smoke model packed)
    crosses the bridge; paged `generate` gives equal tokens."""
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    jq = j_quantize_tree(jp, JQuantConfig(8, 1, min_features=1))
    tq = params_from_jax(jax.tree.map(np.asarray, jq), cfg, "cpu")
    ffn = tq["layers"]["moe" if cfg.n_experts else "mlp"]
    assert all(isinstance(w, PimWeight) for k, w in ffn.items()
               if k.startswith("w"))
    prompts = np.random.default_rng(4).integers(0, 128, (3, 10)).astype(
        np.int32)
    sc = dict(max_cache_len=32, max_new_tokens=6, paged=True, block_size=4)
    ref = JEngine(jcfg, jq, JServeConfig(**sc)).generate(jnp.asarray(prompts))
    port = ServeEngine(cfg, tq, ServeConfig(device="cpu", **sc)).generate(
        prompts)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))

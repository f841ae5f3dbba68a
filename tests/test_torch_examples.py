"""The port's examples (`examples/quickstart_torch.py`,
`examples/serve_pim_gemv_torch.py`) on the CPU, against the reference's
(`examples/quickstart.py`, `examples/serve_pim_gemv.py`):

* the quickstart's FPGA half prints the reference's lines word for word
  (the bit-exact GEMV, its cycles and the analytic model's, the U55 peak,
  the Gold Standard fit), its GPU half the reference's HBM amplifications,
  and its relative errors agree with the reference's within 1e-5;
* the serving example's packed fractions equal the reference's
  `ServeEngine.quantize` on the same smoke config, and its paged prefix
  drain gives the tokens of the drain without prefix sharing;
* without `--device cpu` both refuse to run where there is no card.
"""

import contextlib
import importlib.util
import io
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels import ops as j_ops
from repro.models import init_lm as j_init_lm
from repro.quant.bitplane import PimQuantConfig as JPimQuantConfig
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.kernels import ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, argv):
    mod = _load(name)
    out = io.StringIO()
    old = sys.argv
    sys.argv = [name] + argv
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = old
    return out.getvalue()


@pytest.fixture(scope="module")
def quickstart():
    port = _run("quickstart_torch", ["--device", "cpu"])
    ref = _load("quickstart")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ref.fpga_side()
        ref.tpu_side()
    return port, out.getvalue()


def test_quickstart_fpga_lines_equal_the_reference(quickstart):
    port, ref = quickstart
    section = lambda s: s.split("=== 2.")[0]  # noqa: E731
    assert section(port) == section(ref)
    assert "bit-exact vs numpy, 2116 cycles (analytic model: 2116)" in port


def test_quickstart_amplifications_equal_the_reference(quickstart):
    port, ref = quickstart
    amp = re.compile(r"n_bits=\d group=\d \([^)]*\)+: HBM amplification "
                     r"[\d.]+x")
    assert amp.findall(port) == amp.findall(ref)
    assert len(amp.findall(port)) == 3


@pytest.mark.parametrize("n_bits,group", [(8, 1), (4, 1), (8, 2)])
def test_quickstart_relative_errors_agree(n_bits, group):
    rng = np.random.default_rng(1)
    w_np = rng.normal(size=(1024, 1024))
    x_np = rng.normal(size=(4, 1024))
    w, x = (torch.tensor(a, dtype=torch.float32) for a in (w_np, x_np))
    planes, scale = ops.quantize_and_pack(w, n_bits, group)
    y = ops.bitplane_matmul(x, planes, scale, n_bits=n_bits, group=group)
    rel = float(torch.linalg.norm(y - x @ w) / torch.linalg.norm(x @ w))
    jw, jx = (jnp.asarray(a, jnp.float32) for a in (w_np, x_np))
    jp, js = j_ops.quantize_and_pack(jw, n_bits, group, impl="ref")
    jy = j_ops.bitplane_matmul(jx, jp, js, n_bits=n_bits, group=group,
                               impl="ref")
    jrel = float(jnp.linalg.norm(jy - jx @ jw) / jnp.linalg.norm(jx @ jw))
    assert abs(rel - jrel) <= 1e-5, (rel, jrel)


@pytest.fixture(scope="module")
def served():
    return _run("serve_pim_gemv_torch", ["--device", "cpu"])


def test_serving_packed_fractions_equal_the_reference(served):
    cfg = j_get_config("qwen2-1.5b", smoke=True)
    params = j_init_lm(jax.random.PRNGKey(0), cfg)
    want = []
    for n_bits, group in [(8, 1), (8, 2)]:
        e = JServeEngine(cfg, params, JServeConfig(max_cache_len=48,
                                                   max_new_tokens=8))
        frac = e.quantize(JPimQuantConfig(n_bits=n_bits, group=group,
                                          min_features=16))
        want.append(f"packed {frac:.0%} of param bytes")
    got = re.findall(r"packed \d+% of param bytes", served)
    assert got == want


def test_serving_prefix_drain_keeps_the_tokens(served):
    assert "prefix drain: same tokens as without prefix sharing: True" \
        in served
    assert "6 ragged requests, 24 tokens" in served
    dense = re.search(r"dense tokens\s*: \[([^\]]*)\]", served).group(1)
    assert len(dense.split(",")) == 8
    assert "kernel launches on cpu: K1=0 K2=0 K3=0 K4=0 K5=0" in served


@pytest.mark.parametrize("name", ["quickstart_torch", "serve_pim_gemv_torch"])
def test_examples_refuse_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(name, [])

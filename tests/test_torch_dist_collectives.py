"""The paper's reduction networks as collectives, and the int8
error-feedback all-reduce, on 8 gloo ranks of the port against the
reference on 8 forced host devices.

One world of 8 CPU ranks (`repro_torch.dist.spawn`, `file://` store)
runs every case once (`torch_dist_cases.collectives_rank`); one
reference subprocess (`XLA_FLAGS=--xla_force_host_platform_device_count=8`,
as `tests/test_dist_subprocess.py` starts it) runs the same inputs and
returns numpy. Each test then compares one part:
  * every schedule of `SCHEDULES` equals the reference's
    `make_sharded_allreduce` and its psum (`tree`): exactly on integer
    values, within 1e-6 on normal ones — and the two built of permutes
    (linear, binary hopping) equal the reference's bit for bit on normal
    values too: the same pairs, the same adds in the same order;
  * `reduce_to_zero_binary_hopping` leaves sum(1..8) = 36 on rank 0;
  * the bytes each rank moves (`dist.collectives` counts) equal
    `collective_bytes_per_device` for every schedule;
  * `compressed_psum` on `linspace(-1, 1, 512)` as [8, 64] (the
    reference test's input): codes and shared scale exact, mean and
    residual within f32 rounding (1e-7 absolute; values <= 1);
  * binary hopping refuses axis sizes 3 and 6 with the reference's
    `ValueError`.
"""

import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.reduction import (
    allreduce_binary_hopping,
    reduce_to_zero_binary_hopping,
)
from repro_torch.dist import spawn
from repro_torch.launch.mesh import Mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
RANKS = 8


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "schedules": {
            # the reference test's input, and one whose shard (64 f32)
            # splits into 8 blocks, so rs-ag pads nothing
            "int_8x4": np.arange(32, dtype=np.float32).reshape(8, 4) + 1,
            "int_8x64": rng.integers(-1000, 1000, (8, 64)).astype(np.float32),
            "normal_8x64": rng.standard_normal((8, 64)).astype(np.float32),
        },
        "west": (np.arange(8, dtype=np.float32) + 1).reshape(8, 1),
        "grads": np.linspace(-1, 1, 8 * 64, dtype=np.float32).reshape(8, 64),
    }


REFERENCE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.core.reduction import (SCHEDULES, make_sharded_allreduce,
                                      reduce_to_zero_binary_hopping)
    from repro.optim.compress import _quantize, compressed_psum
    z = np.load(sys.argv[1], allow_pickle=True)
    inputs = z["inputs"].item()
    mesh = jax.make_mesh((8,), ("x",))
    out = {}
    for case, x in inputs["schedules"].items():
        for name in SCHEDULES:
            out[f"{case}/{name}"] = np.asarray(
                make_sharded_allreduce(mesh, "x", name)(jnp.asarray(x)))
    f = jax.jit(jax.shard_map(
        lambda s: reduce_to_zero_binary_hopping(s, "x"),
        mesh=mesh, in_specs=P("x"), out_specs=P("x")))
    out["west"] = np.asarray(f(jnp.asarray(inputs["west"])))
    g = jnp.asarray(inputs["grads"])
    fj = jax.jit(jax.shard_map(
        lambda gr, r: compressed_psum(gr, r, "x"), mesh=mesh,
        in_specs=({"w": P("x")}, {"w": P("x")}),
        out_specs=({"w": P("x")}, {"w": P("x")})))
    mean, res = fj({"w": g}, {"w": jnp.zeros_like(g)})
    out["mean"] = np.asarray(mean["w"])
    out["residual"] = np.asarray(res["w"])
    q, scale = _quantize(g)
    out["codes"] = np.asarray(q)
    out["scale"] = np.asarray(scale)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port results by rank, reference arrays): the 8-rank world and the
    reference subprocess run side by side."""
    tmp = tmp_path_factory.mktemp("collectives")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", inputs=np.array(inputs, dtype=object))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "inputs.npz"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = spawn.run("torch_dist_cases:collectives_rank", RANKS,
                         args=(inputs,), timeout=100, paths=[TESTS])
    finally:
        _, err = ref.communicate(timeout=110)
    assert ref.returncode == 0, err[-4000:]
    with np.load(tmp / "ref.npz") as z:
        reference = {k: z[k] for k in z.files}
    return inputs, port, reference


CASES = ["int_8x4", "int_8x64", "normal_8x64"]
#: the schedules built of permutes: the same pairs and the same adds in
#: the same order as the reference's, so equal bit for bit on any values
PERMUTES = ("linear", "binary-hopping")
NAMES = ["linear", "binary-hopping", "tree", "rs-ag"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", CASES)
def test_schedule_equals_reference_and_psum(runs, case, name):
    inputs, port, ref = runs
    whole = inputs["schedules"][case]
    total = whole.sum(axis=0, dtype=np.float64)
    for rank, r in enumerate(port):
        got = r["schedules"][(case, name)].numpy()
        want = ref[f"{case}/{name}"][rank: rank + 1]
        psum = ref[f"{case}/tree"][rank: rank + 1]
        if case.startswith("int") or name in PERMUTES:
            np.testing.assert_array_equal(got, want)
        if case.startswith("int"):
            np.testing.assert_array_equal(got, psum)
            np.testing.assert_array_equal(got, total[None].astype(np.float32))
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            np.testing.assert_allclose(got, psum, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_bytes_moved_equal_the_model(runs, name):
    """The ring model of `collective_bytes_per_device`: (P-1) shards for
    the linear ring, log2 P for binary hopping, 2(P-1)/P for rs-ag and
    the library's all-reduce — on a shard that splits into P blocks."""
    _, port, _ = runs
    for r in port:
        assert r["bytes"][("int_8x64", name)] == \
            r["model_bytes"][("int_8x64", name)] == {
                "linear": 256 * 7, "binary-hopping": 256 * 3,
                "tree": 448, "rs-ag": 448}[name]


def test_reduce_to_zero_lands_on_rank_zero(runs):
    _, port, ref = runs
    assert port[0]["west"].item() == 36.0 == ref["west"][0, 0]
    for rank, r in enumerate(port):
        np.testing.assert_array_equal(r["west"].numpy(),
                                      ref["west"][rank: rank + 1])


def test_compressed_psum_equals_reference(runs):
    inputs, port, ref = runs
    exact = inputs["grads"].mean(axis=0)
    for rank, r in enumerate(port):
        np.testing.assert_array_equal(r["codes"].numpy(),
                                      ref["codes"][rank: rank + 1])
        assert r["scale"].item() == ref["scale"].item()
        np.testing.assert_allclose(r["mean"].numpy(),
                                   ref["mean"][rank: rank + 1],
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(r["residual"].numpy(),
                                   ref["residual"][rank: rank + 1],
                                   rtol=0, atol=1e-7)
        err = np.max(np.abs(r["mean"].numpy() - exact)) / np.max(np.abs(exact))
        assert err < 0.05
        assert float(r["residual"].abs().max()) > 0


@pytest.mark.parametrize("p", [3, 6])
def test_binary_hopping_refuses_non_power_of_two(p):
    mesh = Mesh((p,), ("x",))
    x = torch.ones(4)
    for fn in (allreduce_binary_hopping, reduce_to_zero_binary_hopping):
        with pytest.raises(ValueError, match="power-of-two"):
            fn(x, "x", mesh)

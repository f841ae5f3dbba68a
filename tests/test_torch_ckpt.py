"""Checkpointing in the PyTorch port: the reference's substrate checks
(round trip, keep_n GC, crash safety, async save, PimWeight leaves)
inside the port, and the two packages against each other: the same
state saves under the same keys in both, and each package restores the
other's checkpoint — an AdamW training state and a bit-plane quantized
tree — value for value. bf16 leaves save in the reference's bytes (raw
2-byte voids, `'|V2'`) and restore bit for bit in the port, from either
package's file."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import get_config as j_get_config
from repro.models import init_lm as j_init_lm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.quant.bitplane import PimQuantConfig as JPimQuantConfig
from repro.quant.bitplane import PimWeight as JPimWeight
from repro.quant.bitplane import quantize_tree as j_quantize_tree
from repro_torch.bridge import params_from_jax
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.checkpoint import _flatten, _items
from repro_torch.configs import get_config
from repro_torch.models import init_lm
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init, adamw_update
from repro_torch.quant.bitplane import PimQuantConfig, PimWeight, quantize_tree


def _state(x=1.0):
    return {"params": {"w_k": torch.full((4, 4), x)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros(tree, dtype=None):
    """Zeros shaped as `tree`'s leaves, in their dtypes or in `dtype`."""
    if isinstance(tree, dict):
        return {k: _zeros(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_zeros(v, dtype) for v in tree])
    if isinstance(tree, PimWeight):
        return PimWeight(torch.zeros_like(tree.planes),
                         torch.zeros_like(tree.scale), tree.n_bits,
                         tree.group)
    return torch.zeros_like(tree, dtype=dtype)


def _saved(directory, step):
    with np.load(os.path.join(directory, f"step_{step:08d}",
                              "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def _keys(directory, step):
    return sorted(_saved(directory, step))


# ---------------------------------------------------------------------------
# the reference's substrate checks, inside the port
# ---------------------------------------------------------------------------

def test_ckpt_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(10, _state(3.0))
    restored, step = mgr.restore(_zeros(_state()))
    assert step == 10
    assert float(restored["params"]["w_k"][0, 0]) == 3.0
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 7
    assert restored["step"].shape == ()


def test_ckpt_restores_into_the_target_dtype(tmp_path):
    """The target's leaf decides the dtype, as `arr.astype(want_dtype)`
    in the reference."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.arange(6, dtype=torch.float32)})
    restored, _ = mgr.restore({"w": torch.zeros(6, dtype=torch.float64)})
    assert restored["w"].dtype == torch.float64
    assert restored["w"].tolist() == list(range(6))


def test_ckpt_keep_n_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (10, 20, 30, 40):
        mgr.save(s, _state(float(s)))
    man = mgr.manifest()
    assert man["latest"] == 40
    assert man["steps"] == [30, 40]
    assert not os.path.exists(os.path.join(tmp_path, "step_00000010"))


def test_ckpt_crash_safety(tmp_path):
    """A stale tmp dir (a crashed write) is ignored."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(10, _state(1.0))
    os.makedirs(os.path.join(tmp_path, "step_00000020.tmp"))
    assert mgr.latest_step() == 10
    _, step = mgr.restore(_state())
    assert step == 10


def test_ckpt_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state(2.0)
    mgr.save_async(5, state)
    state["params"]["w_k"].fill_(9.0)     # the snapshot was taken at call
    mgr.wait()
    restored, step = mgr.restore(_zeros(_state()))
    assert step == 5 and float(restored["params"]["w_k"][0, 0]) == 2.0


def test_ckpt_missing_leaf_and_empty_dir_raise(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state())
    mgr.save(1, _state())
    with pytest.raises(KeyError, match="other"):
        mgr.restore({"other": torch.zeros(1)})


def test_ckpt_restores_pim_weights(tmp_path):
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 8))
                         .astype(np.float32))
    q = quantize_tree({"layer": {"wq": w}},
                      PimQuantConfig(n_bits=8, min_features=1, impl="ref"))
    assert isinstance(q["layer"]["wq"], PimWeight)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, q)
    assert _keys(str(tmp_path), 1) == ["layer$wq$0", "layer$wq$1"]
    restored, _ = mgr.restore(_zeros(q))
    got = restored["layer"]["wq"]
    assert isinstance(got, PimWeight)
    assert (got.n_bits, got.group) == (8, 1)
    assert torch.equal(got.planes, q["layer"]["wq"].planes)
    assert torch.equal(got.scale, q["layer"]["wq"].scale)


def test_bf16_leaf_is_refused(tmp_path):
    """bf16 leaves are not refused: `save` and `save_async` write each
    as 2-byte voids, and `restore` gives back every leaf bit for bit —
    a small tree, a 0-dim leaf, and the port's own serving params."""
    rng = np.random.default_rng(0)
    w_k = rng.normal(size=(3, 5)).astype(np.float32)
    small = {"params": {"w_k": torch.from_numpy(w_k).to(torch.bfloat16)},
             "scalar": torch.tensor(-1.5, dtype=torch.bfloat16),
             "step": torch.tensor(7, dtype=torch.int32)}
    serving = init_lm(get_config("qwen2-1.5b", smoke=True),
                      torch.Generator().manual_seed(0), "cpu")
    # the weights in bf16, the norm gains in f32
    assert {x.dtype for _, x in _items(serving)} == {
        torch.bfloat16, torch.float32}
    mgr = CheckpointManager(str(tmp_path))
    for step, tree in ((1, small), (2, serving)):
        dtypes = {key: "|V2" if x.dtype == torch.bfloat16
                  else x.numpy().dtype.str for key, x in _items(tree)}
        mgr.save(step, tree)
        mgr.save_async(step + 10, tree)
        mgr.wait()
        for s in (step, step + 10):
            saved = _saved(str(tmp_path), s)
            assert {k: a.dtype.str for k, a in saved.items()} == dtypes
            restored, got_step = mgr.restore(_zeros(tree), step=s)
            assert got_step == s
            for (key, got), (_, want) in zip(_items(restored),
                                             _items(tree)):
                assert got.dtype == want.dtype, key
                assert got.shape == want.shape, key
                assert torch.equal(got, want), key


def test_bf16_async_snapshot_is_taken_at_call(tmp_path):
    """The bf16 snapshot `save_async` writes is a copy: an in-place
    update after the call does not reach the file."""
    mgr = CheckpointManager(str(tmp_path))
    w = torch.full((4, 4), 2.5, dtype=torch.bfloat16)
    mgr.save_async(1, {"w": w})
    w.fill_(9.0)
    mgr.wait()
    restored, _ = mgr.restore({"w": torch.zeros(4, 4, dtype=torch.bfloat16)})
    assert torch.equal(restored["w"], torch.full((4, 4), 2.5,
                                                 dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def _training_states():
    """The same AdamW state after one step in both packages (qwen2-1.5b
    smoke in f32, the reference's tree carried across)."""
    jcfg = dataclasses.replace(j_get_config("qwen2-1.5b", smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype="float32")
    jp = j_init_lm(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu",
                         dtype=torch.float32)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), jax.tree.map(np.asarray, jp))
    jp, js, _ = j_adamw_update(jax.tree.map(jnp.asarray, grads),
                               j_adamw_init(jp), jp, JAdamWConfig())
    tgrads = params_from_jax(grads, cfg, "cpu", dtype=torch.float32)
    tp, ts, _ = adamw_update(tgrads, adamw_init(tp), tp, AdamWConfig())
    return {"params": jp, "opt": js}, {"params": tp, "opt": ts}


def test_training_state_keys_are_equal(tmp_path):
    jstate, tstate = _training_states()
    JCheckpointManager(str(tmp_path / "ref")).save(1, jstate)
    CheckpointManager(str(tmp_path / "port")).save(1, tstate)
    keys = _keys(str(tmp_path / "port"), 1)
    assert keys == _keys(str(tmp_path / "ref"), 1)
    assert "opt$step" in keys and "opt$m$layers$attn$wq" in keys
    assert "params$layers$attn$wq" in keys


def test_reference_restores_a_port_training_checkpoint(tmp_path):
    jstate, tstate = _training_states()
    CheckpointManager(str(tmp_path)).save(3, tstate)
    restored, step = JCheckpointManager(str(tmp_path)).restore(
        jax.tree.map(jnp.zeros_like, jstate))
    assert step == 3
    assert int(restored["opt"].step) == 1
    port = dict(_port_arrays(tstate))
    for key, got in _ref_arrays(restored):
        assert got.dtype == port[key].dtype, key
        np.testing.assert_array_equal(got, port[key], err_msg=key)


def test_port_restores_a_reference_training_checkpoint(tmp_path):
    jstate, tstate = _training_states()
    JCheckpointManager(str(tmp_path)).save(3, jstate)
    restored, step = CheckpointManager(str(tmp_path)).restore(
        _zeros(tstate))
    assert step == 3
    assert isinstance(restored["opt"], AdamWState)
    assert restored["opt"].step.dtype == torch.int32
    assert restored["opt"].step.shape == ()
    assert int(restored["opt"].step) == 1
    ref = dict(_ref_arrays(jstate))
    for key, got in _port_arrays(restored):
        assert got.dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got, ref[key], err_msg=key)


def _ref_arrays(tree):
    """The reference's `(key, array)` pairs, keyed as its `_path_str`."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = []
        for p in path:
            for attr in ("key", "idx", "name"):
                if hasattr(p, attr):
                    parts.append(str(getattr(p, attr)))
                    break
        yield "$".join(parts), np.asarray(leaf)


def _port_arrays(tree):
    return sorted(_flatten(tree).items())


def _quantized_trees():
    rng = np.random.default_rng(1)
    tree = {"layers": {"wq": rng.normal(size=(2, 32, 16)).astype(np.float32),
                       "g": np.ones((2, 32), np.float32)},
            "w_out": rng.normal(size=(32, 24)).astype(np.float32)}
    jq = j_quantize_tree(jax.tree.map(jnp.asarray, tree),
                         JPimQuantConfig(n_bits=8, min_features=1))
    assert isinstance(jq["layers"]["wq"], JPimWeight)
    assert isinstance(jq["w_out"], JPimWeight)
    cfg = get_config("qwen2-1.5b", smoke=True)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), cfg, "cpu",
                         dtype=torch.float32)
    assert isinstance(tq["layers"]["wq"], PimWeight)
    return jq, tq


def test_quantized_tree_keys_are_equal(tmp_path):
    jq, tq = _quantized_trees()
    JCheckpointManager(str(tmp_path / "ref")).save(1, jq)
    CheckpointManager(str(tmp_path / "port")).save(1, tq)
    keys = _keys(str(tmp_path / "port"), 1)
    assert keys == _keys(str(tmp_path / "ref"), 1)
    assert "layers$wq$0" in keys and "layers$wq$1" in keys


def test_reference_restores_port_pim_weights(tmp_path):
    jq, tq = _quantized_trees()
    CheckpointManager(str(tmp_path)).save(2, tq)
    restored, _ = JCheckpointManager(str(tmp_path)).restore(
        jax.tree.map(jnp.zeros_like, jq))
    for got, want in ((restored["layers"]["wq"], jq["layers"]["wq"]),
                      (restored["w_out"], jq["w_out"])):
        assert isinstance(got, JPimWeight)
        np.testing.assert_array_equal(np.asarray(got.planes),
                                      np.asarray(want.planes))
        np.testing.assert_array_equal(np.asarray(got.scale),
                                      np.asarray(want.scale))
    np.testing.assert_array_equal(np.asarray(restored["layers"]["g"]),
                                  np.asarray(jq["layers"]["g"]))


def test_port_restores_reference_pim_weights(tmp_path):
    jq, tq = _quantized_trees()
    JCheckpointManager(str(tmp_path)).save(2, jq)
    restored, _ = CheckpointManager(str(tmp_path)).restore(_zeros(tq))
    for got, want in ((restored["layers"]["wq"], jq["layers"]["wq"]),
                      (restored["w_out"], jq["w_out"])):
        assert isinstance(got, PimWeight)
        assert (got.n_bits, got.group) == (want.n_bits, want.group)
        assert got.planes.dtype == torch.uint8
        np.testing.assert_array_equal(got.planes.numpy(),
                                      np.asarray(want.planes))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))


# ---------------------------------------------------------------------------
# bf16 across the two packages
# ---------------------------------------------------------------------------

def _bf16_values():
    """The same bf16 values for both packages, from a numpy seed: a
    matrix, a stacked 3-d leaf and a 0-dim leaf, with the bf16 specials
    (signed zeros, infinities, the smallest subnormal) among them."""
    rng = np.random.default_rng(26)
    mat = rng.normal(scale=3.0, size=(6, 10)).astype(np.float32)
    mat.flat[:5] = [0.0, -0.0, np.inf, -np.inf, 2.0 ** -133]
    return {"layers": {"wq": rng.normal(size=(2, 8, 4)).astype(np.float32)},
            "w_out": mat, "scale": np.float32(-1.5)}


def _jax_bf16(values):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype=jnp.bfloat16), values)


def _torch_bf16(values):
    return {k: _torch_bf16(v) if isinstance(v, dict)
            else torch.from_numpy(np.asarray(v)).to(torch.bfloat16)
            for k, v in values.items()}


@pytest.mark.parametrize("how", ["save", "save_async"])
def test_bf16_bytes_equal_the_references(tmp_path, how):
    """Each `arrays.npz` entry the port writes for a bf16 leaf has the
    dtype (`'|V2'`) and the bytes of the reference's entry for the same
    values."""
    values = _bf16_values()
    JCheckpointManager(str(tmp_path / "ref")).save(1, _jax_bf16(values))
    mgr = CheckpointManager(str(tmp_path / "port"))
    getattr(mgr, how)(1, _torch_bf16(values))
    mgr.wait()
    ref = _saved(str(tmp_path / "ref"), 1)
    port = _saved(str(tmp_path / "port"), 1)
    assert sorted(port) == sorted(ref) == ["layers$wq", "scale", "w_out"]
    for key, want in ref.items():
        assert want.dtype.str == "|V2", key
        assert port[key].dtype.str == want.dtype.str, key
        assert port[key].shape == want.shape, key
        assert port[key].tobytes() == want.tobytes(), key


def test_port_restores_a_reference_bf16_checkpoint(tmp_path):
    """Into bf16 targets the reference's bf16 leaves come back bit for
    bit; into f32 targets as the bf16 values widened, exactly."""
    values = _bf16_values()
    jtree = _jax_bf16(values)
    JCheckpointManager(str(tmp_path)).save(4, jtree)
    mgr = CheckpointManager(str(tmp_path))
    want = _torch_bf16(values)
    bf16, step = mgr.restore(_zeros(want))
    assert step == 4
    f32, _ = mgr.restore(_zeros(_torch_bf16(values), torch.float32))
    ref = dict(_ref_arrays(jtree))
    for (key, got), (_, w), (_, wide) in zip(_items(bf16),
                                             _items(want),
                                             _items(f32)):
        assert got.dtype == torch.bfloat16, key
        assert torch.equal(got, w), key
        np.testing.assert_array_equal(
            got.view(torch.uint16).numpy(), ref[key].view(np.uint16),
            err_msg=key)
        assert wide.dtype == torch.float32, key
        assert torch.equal(wide, w.float()), key
        np.testing.assert_array_equal(
            wide.numpy(), ref[key].astype(np.float32), err_msg=key)


def test_bf16_leaf_into_an_integer_target_raises(tmp_path):
    """bf16 bits are not an integer's: the error names the key."""
    JCheckpointManager(str(tmp_path)).save(1, _jax_bf16(_bf16_values()))
    mgr = CheckpointManager(str(tmp_path))
    target = _zeros(_torch_bf16(_bf16_values()))
    for dtype in (torch.int32, torch.bool):
        target["w_out"] = torch.zeros(6, 10, dtype=dtype)
        with pytest.raises(TypeError, match=r"'w_out'.*bfloat16"):
            mgr.restore(target)


@pytest.mark.parametrize("saved_by", ["reference", "port"])
def test_reference_cannot_restore_a_bf16_checkpoint(tmp_path, saved_by):
    """The reference's `restore` casts each '|V2' array with `astype`,
    which numpy refuses: it fails on its own bf16 file and on the port's
    alike, so the failure is the reference's and not the bytes'."""
    values = _bf16_values()
    if saved_by == "reference":
        JCheckpointManager(str(tmp_path)).save(1, _jax_bf16(values))
    else:
        CheckpointManager(str(tmp_path)).save(1, _torch_bf16(values))
    with pytest.raises(ValueError, match="cast"):
        JCheckpointManager(str(tmp_path)).restore(
            jax.tree.map(jnp.zeros_like, _jax_bf16(values)))

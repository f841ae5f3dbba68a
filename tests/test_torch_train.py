"""Training on the PyTorch port, held against the JAX reference on the
CPU: the schedule, AdamW, the data pipeline, the loss, one step and
three steps of `make_train_step` on every `ARCH_IDS` smoke config, the
`Trainer` and `launch.train`.

Parity runs in f32 (`dataclasses.replace(cfg, dtype="float32")`) from
the reference's own `init_lm` / `init_encdec` tree carried across with
`bridge.params_from_jax(..., dtype=torch.float32)`; whisper's frames and
llava's patches are the same numpy stub embeddings in both packages.
Tolerances, all f32 (measured worst case in brackets, over the ten
configs):
  * the loss metrics within 1e-5 absolute (loss ~4.9; [9.5e-7]);
  * each gradient leaf within 1e-4 of its largest |value| ([6.7e-6]);
  * m and v after three steps within 1e-6 absolute ([1.5e-7]);
  * params after three steps within 1e-4 absolute, a tenth of the lr
    ([1.9e-5]): AdamW's early updates are near lr * sign(g), so a
    near-zero gradient whose last bits differ moves its element by a
    part of the lr;
  * grad_norm within 1e-5 relative; the lr, `batch_at`'s batches and
    the decayed-path set exactly.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import batch_at as j_batch_at
from repro.models import init_lm as j_init_lm
from repro.models.encdec import init_encdec as j_init_encdec
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim.adamw import _is_decayable as j_is_decayable
from repro.optim.adamw import _tree_paths as j_tree_paths
from repro.optim.schedule import linear_warmup_constant as j_linear
from repro.optim.schedule import warmup_cosine as j_cosine
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import make_loss_fn as j_make_loss_fn
from repro.train import make_train_step as j_make_train_step
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, PrefetchLoader, batch_at, host_shard
from repro_torch.models import init_lm
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    linear_warmup_constant,
    warmup_cosine,
)
from repro_torch.optim.adamw import _is_decayable, _tree_paths, tree_items
from repro_torch.train import (
    Trainer,
    TrainerConfig,
    make_loss_fn,
    make_train_step,
    softmax_cross_entropy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

METRIC_ATOL = 1e-5
GRAD_RTOL = 1e-4        # of the leaf's largest |gradient|
STATE_ATOL = 1e-6       # m, v
PARAM_ATOL = 1e-4       # params after three steps at lr 1e-3
GNORM_RTOL = 1e-5
LR = 1e-3


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _t_leaves(tree):
    return [x.detach().numpy() for _, x in tree_items(tree)]


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("peak,warmup,total", [
    (3e-4, 100, 10_000), (1e-3, 10, 300), (3e-3, 100, 100), (1e-3, 0, 50),
    (5e-3, 7, 13)])
def test_schedules_equal_the_reference_at_every_step(peak, warmup, total):
    steps = np.arange(0, total + 5, dtype=np.int32)
    want = np.asarray(j_cosine(jnp.asarray(steps), peak, warmup, total))
    got = warmup_cosine(torch.from_numpy(steps), peak, warmup, total)
    np.testing.assert_array_equal(got.numpy(), want)
    # one step at a time, as the train step calls it
    for s in (0, warmup, total // 2, total):
        one = warmup_cosine(torch.tensor(s, dtype=torch.int32), peak,
                            warmup, total)
        assert one.dtype == torch.float32 and one.item() == want[s]
    want = np.asarray(j_linear(jnp.asarray(steps), peak, warmup))
    got = linear_warmup_constant(torch.from_numpy(steps), peak, warmup)
    np.testing.assert_array_equal(got.numpy(), want)


def test_warmup_cosine_shape():
    assert float(warmup_cosine(torch.tensor(0), 1.0, 10, 100)) == 0.0
    assert float(warmup_cosine(torch.tensor(10), 1.0, 10, 100)) == \
        pytest.approx(1.0)
    assert float(warmup_cosine(torch.tensor(100), 1.0, 10, 100)) == \
        pytest.approx(0.1, abs=1e-5)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _random_tree(rng):
    """Nested dicts with stacked [L, ...] leaves, norm gains, biases and
    a `b_` leaf: every branch of the decay rule."""
    shapes = {
        "embed": (40, 8),
        "layers": {"attn": {"wq": (3, 8, 8), "bq": (3, 8)},
                   "ln1": {"g": (3, 8)},
                   "slstm": {"b_gates": (3, 16), "r_gates": (3, 2, 4, 8)}},
        "final_norm": {"g": (8,)},
        "bias": (8,),
    }

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.normal(size=s).astype(np.float32)
    return make(shapes)


@pytest.mark.parametrize("clip_norm", [1.0, 1e9])
def test_adamw_update_equals_the_reference(clip_norm):
    rng = np.random.default_rng(0)
    params = _random_tree(rng)
    jcfg = JAdamWConfig(lr=1e-2, clip_norm=clip_norm)
    tcfg = AdamWConfig(lr=1e-2, clip_norm=clip_norm)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    js, ts = j_adamw_init(jp), adamw_init(tp)
    for step in range(4):
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.3)
                             .astype(np.float32), params)
        lr = j_cosine(js.step, 1e-2, 2, 10)
        jp, js, jn = j_adamw_update(jax.tree.map(jnp.asarray, grads), js, jp,
                                    jcfg, lr=lr)
        tp, ts, tn = adamw_update(
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), grads), ts,
            tp, tcfg, lr=warmup_cosine(ts.step, 1e-2, 2, 10))
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        assert float(tn) == pytest.approx(float(jn), rel=GNORM_RTOL)
        for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            for g, w in zip(_t_leaves(got), _np_leaves(want)):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_adamw_updates_in_place():
    p = {"w_k": torch.ones((2, 2))}
    ident = p["w_k"]
    state = adamw_init(p)
    m = state.m["w_k"]
    p2, state2, _ = adamw_update({"w_k": torch.full((2, 2), 0.5)}, state, p,
                                 AdamWConfig())
    assert p2["w_k"] is ident and state2.m["w_k"] is m
    assert float(ident[0, 0]) < 1.0


def test_adamw_matches_numpy_reference():
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                      clip_norm=1e9)
    w0 = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)
    g = np.array([[0.1, 0.2], [-0.3, 0.4]], np.float32)
    params = {"w_k": torch.from_numpy(w0.copy())}
    p1, _, _ = adamw_update({"w_k": torch.from_numpy(g.copy())},
                            adamw_init(params), params, cfg)
    mhat = 0.1 * g / (1 - 0.9)
    vhat = 0.01 * g ** 2 / (1 - 0.99)
    expect = w0 - 0.1 * (mhat / (np.sqrt(vhat) + 1e-8))
    np.testing.assert_allclose(p1["w_k"].numpy(), expect, rtol=1e-5)


def test_weight_decay_applies_to_kernels_not_norms():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, clip_norm=1e9)
    params = {"w_k": torch.ones((2, 2)), "g": torch.ones((2,))}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    p1, _, _ = adamw_update(grads, adamw_init(params), params, cfg)
    assert float(p1["w_k"][0, 0]) < 1.0
    assert float(p1["g"][0]) == 1.0


def test_clip_by_global_norm():
    clipped, norm = clip_by_global_norm({"a": torch.full((10,), 10.0)}, 1.0)
    assert float(norm) > 1.0
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=1e9)
    params = {"w_k": torch.tensor([[5.0, -5.0]])}
    state = adamw_init(params)
    for _ in range(200):
        params, state, _ = adamw_update({"w_k": 2 * params["w_k"]}, state,
                                        params, cfg)
    assert float(params["w_k"].abs().max()) < 0.1


def _arch_trees(arch):
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    init = j_init_encdec if jcfg.is_encoder_decoder else j_init_lm
    jp = init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu",
                         dtype=torch.float32)
    return jcfg, jp, cfg, tp


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decayed_path_set_equals_the_reference(arch):
    """Including the stacked-tree effect: `[L, d]` vectors such as
    `attn/bq` or `mamba/A_log` are decayed in both packages."""
    _, jp, _, tp = _arch_trees(arch)
    jpaths = jax.tree_util.tree_leaves(j_tree_paths(jp))
    want = {p for p, leaf in zip(jpaths, jax.tree_util.tree_leaves(jp))
            if j_is_decayable(p, leaf)}
    paths = dict(tree_items(_tree_paths(tp)))
    got = {paths[k] for k, leaf in tree_items(tp)
           if _is_decayable(paths[k], leaf)}
    assert got == want and want


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@settings(max_examples=30, deadline=None)
@given(step=st.integers(0, 10_000), vocab=st.integers(2, 200_000),
       seq=st.integers(1, 64), batch=st.integers(1, 8),
       seed=st.integers(0, 2 ** 31 - 1))
def test_batch_at_equals_the_reference(step, vocab, seq, batch, seed):
    got = batch_at(DataConfig(vocab, seq, batch, seed), step)
    want = j_batch_at(JDataConfig(vocab, seq, batch, seed), step)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_targets_are_shifted_tokens_and_host_shard_partitions():
    toks, tgts = batch_at(DataConfig(vocab_size=50, seq_len=8,
                                     global_batch=8), 3)
    assert np.array_equal(toks[:, 1:], tgts[:, :-1])
    parts = [host_shard(toks, i, 4) for i in range(4)]
    assert np.array_equal(np.concatenate(parts), toks)


def test_loader_from_step_k_yields_batch_at_k_on():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=4, seed=3)
    loader = PrefetchLoader(cfg, start_step=7, device="cpu")
    try:
        for k in range(7, 12):
            step, tokens, targets = next(loader)
            want = batch_at(cfg, k)
            assert step == k
            assert isinstance(tokens, torch.Tensor)
            assert np.array_equal(tokens.numpy(), want[0])
            assert np.array_equal(targets.numpy(), want[1])
    finally:
        loader.close()


# ---------------------------------------------------------------------------
# the loss and the step, every ARCH_IDS smoke config
# ---------------------------------------------------------------------------

def test_softmax_cross_entropy_argmax_takes_the_first_maximum():
    logits = torch.zeros((1, 2, 4))
    logits[0, 1, 2] = logits[0, 1, 3] = 1.0
    _, m = softmax_cross_entropy(logits, torch.tensor([[0, 2]]))
    assert float(m["accuracy"]) == 1.0


def _batch(cfg, step, n=4, t=16):
    tokens, targets = j_batch_at(JDataConfig(cfg.vocab_size, t, n), step)
    batch = {"tokens": tokens, "targets": targets}
    rng = np.random.default_rng(100 + step)
    if cfg.is_encoder_decoder:
        batch["frames"] = (0.02 * rng.standard_normal(
            (n, t, cfg.d_model))).astype(np.float32)
    elif cfg.frontend == "vision_stub":
        batch["patches"] = (0.02 * rng.standard_normal(
            (n, min(cfg.frontend_tokens, 8), cfg.d_model))).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _port_grads(cfg, tp, batch):
    leaves = [p for _, p in tree_items(tp)]
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = make_loss_fn(cfg)(tp, _t(batch))
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return {k: v.detach() for k, v in metrics.items()}, grads


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_gradients_equal_the_reference(arch):
    jcfg, jp, cfg, tp = _arch_trees(arch)
    batch = _batch(cfg, 0)
    (_, jm), jg = jax.value_and_grad(j_make_loss_fn(jcfg), has_aux=True)(
        jp, _j(batch))
    tm, tg = _port_grads(cfg, tp, batch)
    for k in ("loss", "nll", "z_loss", "accuracy", "moe_aux"):
        assert abs(float(tm[k]) - float(jm[k])) <= METRIC_ATOL, k
    if cfg.n_experts:
        assert float(tm["moe_aux"]) > 0
    for (path, _), g, w in zip(tree_items(tp), tg, _np_leaves(jg)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=path)


def _three_steps(arch, n_microbatches, remat=False, **over):
    jcfg, jp, cfg, tp = _arch_trees(arch)
    jcfg = dataclasses.replace(jcfg, remat=remat, **over)
    cfg = dataclasses.replace(cfg, remat=remat, **over)
    kw = dict(n_microbatches=n_microbatches, warmup_steps=2, total_steps=10)
    jstep = jax.jit(j_make_train_step(jcfg, JAdamWConfig(lr=LR), **kw))
    tstep = make_train_step(cfg, AdamWConfig(lr=LR), **kw)
    js, ts = j_adamw_init(jp), adamw_init(tp)
    for s in range(3):
        batch = _batch(cfg, s)
        jp, js, jm = jstep(jp, js, _j(batch))
        tp, ts, tm = tstep(tp, ts, _t(batch))
        for k in ("loss", "nll", "z_loss", "accuracy", "moe_aux"):
            assert abs(float(tm[k]) - float(jm[k])) <= METRIC_ATOL, (s, k)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=GNORM_RTOL)
        assert float(tm["lr"]) == float(jm["lr"])
    assert int(ts.step) == int(js.step) == 3
    for got, want, atol in ((tp, jp, PARAM_ATOL), (ts.m, js.m, STATE_ATOL),
                            (ts.v, js.v, STATE_ATOL)):
        for (path, _), g, w in zip(tree_items(got), _t_leaves(got),
                                   _np_leaves(want)):
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_three_train_steps_equal_the_reference(arch):
    _three_steps(arch, 1)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b",
                                  "whisper-medium", "llava-next-34b"])
def test_two_microbatch_steps_equal_the_reference(arch):
    _three_steps(arch, 2)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama4-scout-17b-a16e"])
def test_two_microbatch_moe_steps_at_binding_capacity_equal_the_reference(
        arch):
    """Capacity factor 0.5: each microbatch's rows compete for the
    experts' places and tokens are dropped, so the rows of a microbatch
    and their order decide the result. The one-rank step against the
    reference's `make_train_step(n_microbatches=2)`; the tests of
    `test_torch_dist_families.py` hold the data-split step against this
    one."""
    _three_steps(arch, 2, capacity_factor=0.5)


def test_remat_steps_equal_the_reference():
    """`cfg.remat` on in both packages (`jax.checkpoint` there,
    `torch.utils.checkpoint` here)."""
    _three_steps("qwen2-1.5b", 1, remat=True)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b",
                                  "zamba2-1.2b", "xlstm-350m",
                                  "whisper-medium", "llava-next-34b"])
def test_remat_on_and_off_give_equal_loss_and_gradients(arch):
    _, _, cfg, tp = _arch_trees(arch)
    batch = _batch(cfg, 1)
    off_m, off_g = _port_grads(dataclasses.replace(cfg, remat=False), tp,
                               batch)
    on_m, on_g = _port_grads(dataclasses.replace(cfg, remat=True), tp, batch)
    for k in off_m:
        assert torch.equal(on_m[k], off_m[k]), k
    for a, b in zip(on_g, off_g):
        assert torch.equal(a, b)


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """With `cfg.remat`, each layer body runs twice per step (forward,
    then again in the backward); without it, once."""
    from repro_torch.models import transformer
    _, _, cfg, tp = _arch_trees("qwen2-1.5b")
    calls = []
    real = transformer._ffn

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(transformer, "_ffn", counting)
    batch = _batch(cfg, 0)
    for remat, want in ((False, cfg.n_layers), (True, 2 * cfg.n_layers)):
        calls.clear()
        _port_grads(dataclasses.replace(cfg, remat=remat), tp, batch)
        assert len(calls) == want, remat


def test_init_lm_param_dtype_gives_f32_masters():
    cfg = get_config("qwen2-1.5b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    serve = init_lm(cfg, gen, "cpu")
    train = init_lm(cfg, torch.Generator().manual_seed(0), "cpu",
                    param_dtype=torch.float32)
    assert {x.dtype for _, x in tree_items(train)} == {torch.float32}
    assert torch.bfloat16 in {x.dtype for _, x in tree_items(serve)}
    for (_, a), (_, b) in zip(tree_items(serve), tree_items(train)):
        assert torch.equal(a, b.to(a.dtype))


# ---------------------------------------------------------------------------
# the Trainer (tests/test_system.py's runs, inside the port)
# ---------------------------------------------------------------------------

def _trainer(steps, d, total=40, async_ckpt=False, cfg=None, params=None,
             log_every=5):
    cfg = cfg or get_config("qwen2-1.5b", smoke=True)
    if params is None:
        params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu",
                         param_dtype=torch.float32)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    return Trainer(
        cfg, params, dc, d, opt_cfg=AdamWConfig(lr=5e-3),
        trainer_cfg=TrainerConfig(total_steps=steps, ckpt_every=10,
                                  log_every=log_every, async_ckpt=async_ckpt),
        device="cpu",
    )


def test_trainer_loss_decreases():
    with tempfile.TemporaryDirectory() as d:
        log = _trainer(60, d).run()
    assert log[-1]["loss"] < log[0]["loss"]
    assert all(np.isfinite(row["loss"]) for row in log)
    assert set(log[0]) >= {"loss", "nll", "z_loss", "accuracy", "moe_aux",
                           "grad_norm", "lr", "step", "step_time_s"}


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_trainer_failure_recovery_is_bit_exact(async_ckpt):
    """40 steps straight vs 20 + crash + resume to 40: identical params
    and optimizer state."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        full = _trainer(40, d1, async_ckpt=async_ckpt)
        full.run()
        _trainer(20, d2, async_ckpt=async_ckpt).run()
        resumed = _trainer(40, d2, async_ckpt=async_ckpt)
        assert resumed.start_step == 20
        resumed.run()
    for a, b in zip(_t_leaves(full.params), _t_leaves(resumed.params)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_t_leaves(full.opt_state.m), _t_leaves(resumed.opt_state.m)):
        np.testing.assert_array_equal(a, b)
    assert int(full.opt_state.step) == int(resumed.opt_state.step) == 40
    assert resumed.opt_state.step.shape == ()


def test_microbatch_equivalence():
    cfg = get_config("qwen2-1.5b", smoke=True)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (4, 16), np.int32)),
             "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                      (4, 16), np.int32))}
    out = []
    for n in (1, 2):
        params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu",
                         param_dtype=torch.float32)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3), n_microbatches=n)
        out.append(step(params, adamw_init(params), batch))
    (p1, _, m1), (p2, _, m2) = out
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-2)
    for a, b in zip(_t_leaves(p1), _t_leaves(p2)):
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-4)


def test_straggler_monitor_fires():
    """A step slowed past 3x every earlier step's time is reported. The
    injected delay is 1 s or 5x the slowest step so far, whichever is
    longer, so a loaded host's slow steps cannot hide it."""
    events = []
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(12, d)
        tr.straggler_callback = events.append
        orig = tr.train_step
        seen = []

        def slow_step(*args):
            t0 = time.perf_counter()
            if len(seen) == 9:
                time.sleep(max(1.0, 5 * max(seen)))  # inject a straggler
            out = orig(*args)
            out[2]["loss"].item()
            seen.append(time.perf_counter() - t0)
            return out

        tr.train_step = slow_step
        tr.run()
    slow = [e for e in events if e.step == 9]
    assert len(slow) == 1
    assert slow[0].step_time > 3 * slow[0].ewma


def test_trainer_logs_the_reference_loss_rows():
    """The port's Trainer and the reference's, qwen2-1.5b smoke in f32
    from one tree: the logged rows' loss metrics, grad_norm and lr
    agree over the first 12 steps (lr 5e-3, log every 3)."""
    jcfg, jp, cfg, tp = _arch_trees("qwen2-1.5b")
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        jlog = JTrainer(
            jcfg, jp, JDataConfig(jcfg.vocab_size, 16, 4), d1,
            opt_cfg=JAdamWConfig(lr=5e-3),
            trainer_cfg=JTrainerConfig(total_steps=12, ckpt_every=100,
                                       log_every=3)).run()
        tlog = _trainer(12, d2, cfg=cfg, params=tp, log_every=3).run()
    assert [r["step"] for r in tlog] == [r["step"] for r in jlog] == \
        [0, 3, 6, 9, 11]
    for t, j in zip(tlog, jlog):
        for k in ("loss", "nll", "z_loss", "accuracy", "moe_aux"):
            assert abs(t[k] - j[k]) <= 1e-4, (t["step"], k, t[k], j[k])
        assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-4)
        assert t["lr"] == j["lr"]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         "--arch", "qwen2-1.5b", "--ckpt-dir", str(tmp_path)] + args,
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)


def test_launch_train_on_the_cpu(tmp_path):
    r = _launch(["--device", "cpu", "--steps", "6", "--ckpt-every", "3"],
                tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1].startswith("final loss:")
    assert (tmp_path / "qwen2-1.5b" / "step_00000006").is_dir()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_launch_train_raises_without_a_card(tmp_path):
    r = _launch(["--steps", "2"], tmp_path)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr

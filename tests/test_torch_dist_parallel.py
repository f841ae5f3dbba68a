"""Tensor- and data-parallel runs of the port on gloo ranks, held against
its one-rank runs and the reference's sharded runs.

Two worlds of CPU ranks (`repro_torch.dist.spawn`, `file://` stores),
each started once per module: 8 ranks run tensor parallelism on a
(data, model) = (2, 4) mesh, one data-parallel `make_train_step` step on
(8,) and the elastic checkpoint (saved from blocks on (8,), restored
onto (4, 2) with the specs swapped); 4 ranks run tensor parallelism on
(1, 4) and `Trainer(mesh=)` for 3 steps. A reference subprocess on 8
forced host devices runs `forward` under `sharding_rules` with
`param_shardings` on `AxisType.Auto` meshes of the same shapes (the
axis type its `with_sharding_constraint` accepts under JAX 0.9).

Models: granite-20b smoke (MQA: its one kv head stays whole) and
qwen2-1.5b smoke (GQA, tied embeddings: the tied head's d_model split),
from the reference's `init_lm` carried across (`bridge`), 2 x 16 tokens.
Tolerances:
  * bf16 logits within 3e-2 (rtol and atol, the reference test's own)
    of the port's one-rank forward and of the reference's TP forward;
  * f32 logits within 2e-6 absolute of both (the row-parallel partial
    sums add in another order; 4.7e-7 measured); greedy prefill +
    decode_step tokens equal the one-rank port's at f32;
  * DP on 8 ranks against one rank: bf16 compute with f32 masters, the
    reference test's case (one step under the default warmup), within
    its 1e-3 on loss and rtol 2e-2 / atol 2e-4 on params; f32, two steps
    at the full lr, within training's pinned 1e-5 on the loss metrics
    and 1e-4 (a tenth of the lr; 5.6e-6 measured) on params, and within
    those of the reference's one-device step;
  * the Trainer's params equal on every rank, bit for bit, its loss
    within 1e-5 of the one-rank Trainer's, and a second Trainer resumes
    from rank 0's checkpoint;
  * elastic restore bit-exact on (4, 2) and on one rank, f32 and bf16.
"""

import copy
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_lm as j_init_lm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.bridge import params_from_jax
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.dist import spawn
from repro_torch.dist.sharding import local_block
from repro_torch.launch.mesh import Mesh
from repro_torch.models import decode_step, forward, init_lm, prefill
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import Trainer, TrainerConfig, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
#: model name -> (config, overrides of its smoke config). qwen2-gqa gives
#: qwen2's smoke 8 heads over 2 kv heads: on 4 model ranks each rank's 2
#: query heads read one kv head of the 2 it holds whole
MODELS = {"granite-20b": ("granite-20b", {}), "qwen2-1.5b": ("qwen2-1.5b", {}),
          "qwen2-gqa": ("qwen2-1.5b", {"n_heads": 8, "n_kv_heads": 2})}
ARCHS = tuple(MODELS)
DTYPES = ("bfloat16", "float32")
LR = 1e-3
#: (steps, warmup_steps) of the data-parallel runs by compute dtype. bf16
#: is the reference test's case: one step under the default warmup.
#: f32 runs two steps from the full lr (warmup 0): AdamW's first update
#: is lr * sign(g), which hides small gradient differences; the second
#: is not.
DP_RUNS = {"bfloat16": (1, 100), "float32": (2, 0)}
#: tensor-parallel training: f32 steps at the full lr on (1, 4)
TP_TRAIN_STEPS = 2

REFERENCE = textwrap.dedent("""
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.dist.sharding import sharding_rules
    from repro.launch.specs import param_shardings
    from repro.models import forward, init_lm
    out = {}
    toks = np.load(sys.argv[1])
    for name, (arch, over) in MODELS.items():
        base = dataclasses.replace(get_config(arch, smoke=True), **over)
        params = init_lm(jax.random.PRNGKey(0), base)
        for dt in ("bfloat16", "float32"):
            cfg = dataclasses.replace(base, dtype=dt)
            for shape in ((2, 4), (1, 4)):
                n = shape[0] * shape[1]
                mesh = jax.make_mesh(shape, ("data", "model"),
                                     devices=jax.devices()[:n],
                                     axis_types=(AxisType.Auto,) * 2)
                with mesh, sharding_rules(mesh):
                    psh = param_shardings(jax.eval_shape(lambda: params), mesh)
                    f = jax.jit(lambda p, t: forward(p, t, cfg)[0],
                                in_shardings=(psh, None))
                    out[f"{name}/{dt}/{shape[0]}x{shape[1]}"] = np.asarray(
                        f(params, jnp.asarray(toks)), np.float32)
    np.savez(sys.argv[2], **out)
""")


def _config(name, dtype, reference=False):
    arch, over = MODELS[name]
    get = j_get_config if reference else get_config
    return dataclasses.replace(get(arch, smoke=True), dtype=dtype, **over)


def _params(name, dtype):
    """The reference's `init_lm` tree (PRNGKey(0)) in the port, weights in
    the compute dtype of `dtype`."""
    jcfg = dataclasses.replace(_config(name, dtype, reference=True),
                               dtype="bfloat16")
    jp = jax.tree.map(np.asarray, j_init_lm(jax.random.PRNGKey(0), jcfg))
    return jp, params_from_jax(jp, _config(name, dtype), "cpu")


def _tokens(vocab, shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int64))


def _one_rank(params, name, dtype, tokens, cache_len=24, new_tokens=6):
    cfg = _config(name, dtype)
    with torch.no_grad():
        logits, _ = forward(params, tokens, cfg)
        out, cache = prefill(params, tokens, cfg, cache_len)
        greedy = [out[:, -1].float().argmax(-1)]
        for _ in range(new_tokens - 1):
            out, cache = decode_step(params, greedy[-1][:, None], cache, cfg)
            greedy.append(out[:, -1].float().argmax(-1))
    return logits.float(), torch.stack(greedy, 1)


def _train_batch(vocab):
    return {"tokens": _tokens(vocab, (8, 16), 1).int(),
            "targets": _tokens(vocab, (8, 16), 2).int()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    vocab = get_config("qwen2-1.5b", smoke=True).vocab_size
    toks = _tokens(min(_config(a, "float32").vocab_size for a in ARCHS),
                   (2, 16), 0)
    np.save(tmp / "tokens.npy", toks.numpy().astype(np.int32))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", f"MODELS = {MODELS!r}\n" + REFERENCE,
         str(tmp / "tokens.npy"),
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    tp_cases, single = {}, {}
    for name in ARCHS:
        for dt in DTYPES:
            _, p = _params(name, dt)
            arch, over = MODELS[name]
            tp_cases[f"{name}/{dt}"] = (p, arch, dt, toks, over)
            single[f"{name}/{dt}"] = _one_rank(p, name, dt, toks)
    masters = {dt: params_from_jax(_params("qwen2-1.5b", dt)[0],
                                   get_config("qwen2-1.5b", smoke=True),
                                   "cpu", dtype=torch.float32)
               for dt in DTYPES}
    batch = _train_batch(vocab)
    tp_masters = {name: params_from_jax(_params(name, "float32")[0],
                                        _config(name, "float32"), "cpu",
                                        dtype=torch.float32)
                  for name in ARCHS}
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    data_cfg = DataConfig(vocab_size=vocab, seq_len=16, global_batch=8,
                          seed=3)
    trainer_params = init_lm(get_config("qwen2-1.5b", smoke=True),
                             torch.Generator().manual_seed(0), "cpu",
                             param_dtype=torch.float32)
    try:
        r8 = spawn.run("torch_dist_cases:world8", 8, args=(
            tp_cases, [(masters[dt], "qwen2-1.5b", dt, batch, LR,
                        *DP_RUNS[dt]) for dt in DTYPES],
            str(tmp / "elastic"), w),
            timeout=110, paths=[TESTS])
        r4 = spawn.run("torch_dist_cases:world4", 4, args=(
            tp_cases, (trainer_params, "qwen2-1.5b", data_cfg,
                       str(tmp / "trainer"), 3),
            ({name: (tp_masters[name], *MODELS[name], batch)
              for name in ARCHS}, LR, TP_TRAIN_STEPS)),
            timeout=110, paths=[TESTS])
    finally:
        _, err = ref.communicate(timeout=110)
    assert ref.returncode == 0, err[-4000:]
    with np.load(tmp / "ref.npz") as z:
        reference = {k: z[k] for k in z.files}
    return dict(tmp=tmp, r8=r8, r4=r4, reference=reference, single=single,
                toks=toks, masters=masters, batch=batch, w=w,
                data_cfg=data_cfg, tp_masters=tp_masters)


def _tol(dtype):
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else \
        dict(rtol=0, atol=2e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", ["2x4", "1x4"])
def test_tensor_parallel_forward(runs, mesh, arch, dtype):
    """Each rank's logits (its rows of the batch, whole vocab) against the
    one-rank port and the reference's TP forward."""
    ranks = runs["r8"] if mesh == "2x4" else runs["r4"]
    data = 2 if mesh == "2x4" else 1
    key = f"{arch}/{dtype}"
    single, _ = runs["single"][key]
    ref = runs["reference"][f"{key}/{mesh}"]
    for rank, r in enumerate(ranks):
        got = r["tp"][key]["logits"].numpy()
        rows = slice(rank // 4, rank // 4 + 1) if data == 2 else slice(None)
        np.testing.assert_allclose(got, single[rows].numpy(), **_tol(dtype))
        np.testing.assert_allclose(got, ref[rows], **_tol(dtype))
        counts = r["tp"][key]["counts"]
        assert counts["all_reduce"]["calls"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", ["2x4", "1x4"])
def test_tensor_parallel_greedy_tokens_equal_one_rank(runs, mesh, arch):
    ranks = runs["r8"] if mesh == "2x4" else runs["r4"]
    _, tokens = runs["single"][f"{arch}/float32"]
    for rank, r in enumerate(ranks):
        rows = slice(rank // 4, rank // 4 + 1) if mesh == "2x4" \
            else slice(None)
        np.testing.assert_array_equal(r["tp"][f"{arch}/float32"]["tokens"],
                                      tokens[rows])


def test_tensor_parallel_cache_holds_the_kv_heads_of_the_layout(runs):
    """qwen2 smoke has 2 kv heads: whole on 4 model ranks (2 % 4 != 0);
    granite's single kv head whole too."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    for r in runs["r4"]:
        shp = r["tp"]["qwen2-1.5b/float32"]["cache_k_shape"]
        assert shp == (cfg.n_layers, 2, 24, cfg.n_kv_heads, cfg.hd)


def _dp_single(params, dtype, batch):
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype=dtype)
    steps, warmup = DP_RUNS[dtype]
    p = copy.deepcopy(params)
    opt = adamw_init(p)
    step = make_train_step(cfg, AdamWConfig(lr=LR), warmup_steps=warmup)
    for _ in range(steps):
        p, opt, metrics = step(p, opt, batch)
    return p, opt, metrics


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def test_data_parallel_step_matches_one_rank(runs):
    """f32: the 8-rank step against the one-rank port step and the
    reference's one-device step (f32 masters, f32 compute)."""
    p1, _, m1 = _dp_single(runs["masters"]["float32"], "float32",
                           runs["batch"])
    jcfg = dataclasses.replace(j_get_config("qwen2-1.5b", smoke=True),
                               dtype="float32")
    jp = j_init_lm(jax.random.PRNGKey(0), j_get_config("qwen2-1.5b",
                                                       smoke=True))
    steps, warmup = DP_RUNS["float32"]
    jstep = jax.jit(j_make_train_step(jcfg, JAdamWConfig(lr=LR),
                                      warmup_steps=warmup))
    jb = {k: jax.numpy.asarray(v.numpy()) for k, v in runs["batch"].items()}
    jp2, jopt = jp, j_adamw_init(jp)
    for _ in range(steps):
        jp2, jopt, jm = jstep(jp2, jopt, jb)
    jleaves = dict(_leaves(jax.tree.map(np.asarray, jp2)))
    for r in runs["r8"]:
        dp = r["dp"]["float32"]
        for k in ("loss", "nll", "z_loss", "accuracy"):
            assert abs(dp["metrics"][k] - float(m1[k])) <= 1e-5, k
            assert abs(dp["metrics"][k] - float(jm[k])) <= 1e-5, k
        assert abs(dp["metrics"]["grad_norm"] - float(m1["grad_norm"])) <= \
            1e-5 * float(m1["grad_norm"])
        for (path, a), (_, b) in zip(_leaves(dp["params"]), _leaves(p1)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-4, err_msg=path)
            np.testing.assert_allclose(a.numpy(), jleaves[path], rtol=0,
                                       atol=1e-4, err_msg=path)


def test_data_parallel_step_bf16_compute(runs):
    """bf16 compute, f32 masters: the 8-rank step against the one-rank
    port step within the reference test's tolerances."""
    p1, _, m1 = _dp_single(runs["masters"]["bfloat16"], "bfloat16",
                           runs["batch"])
    for r in runs["r8"]:
        dp = r["dp"]["bfloat16"]
        assert abs(dp["metrics"]["loss"] - float(m1["loss"])) < 1e-3
        for (path, a), (_, b) in zip(_leaves(dp["params"]), _leaves(p1)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-2,
                                       atol=2e-4, err_msg=path)


def test_trainer_on_a_mesh(runs):
    """3 steps of `Trainer(mesh=, batch_spec=)` on 4 ranks: params equal
    on every rank bit for bit and within 1e-4 of a one-rank Trainer's,
    the logged losses within 1e-5; a second Trainer on each rank resumes
    at step 3 from rank 0's checkpoint."""
    ranks = runs["r4"]
    first = ranks[0]["trainer"]
    for r in ranks[1:]:
        for (_, a), (_, b) in zip(_leaves(r["trainer"]["params"]),
                                  _leaves(first["params"])):
            assert torch.equal(a, b)
    for r in ranks:
        assert r["trainer"]["resumed_at"] == 3
    cfg = get_config("qwen2-1.5b", smoke=True)
    params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu",
                     param_dtype=torch.float32)
    tr = Trainer(cfg, params, runs["data_cfg"], str(runs["tmp"] / "one"),
                 trainer_cfg=TrainerConfig(total_steps=3, ckpt_every=2,
                                           log_every=1, async_ckpt=False),
                 device="cpu")
    log = tr.run()
    assert [row["step"] for row in log] == [row["step"]
                                            for row in first["log"]]
    for a, b in zip(log, first["log"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5
    for (path, a), (_, b) in zip(_leaves(tr.params),
                                 _leaves(first["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4,
                                   err_msg=path)


def test_elastic_restore_across_meshes(runs):
    """Saved from blocks on (8,), restored onto (4, 2) with specs
    ("model", "data") and onto one rank: bit-exact."""
    w = runs["w"]
    for r in runs["r8"]:
        e = r["elastic"]
        want = local_block(w, ("model", "data"),
                           Mesh((4, 2), ("data", "model"), rank=e["rank"]))
        assert e["step"] == 1
        assert torch.equal(e["block"], want)
    mgr = CheckpointManager(str(runs["tmp"] / "elastic"))
    r1, _ = mgr.restore({"w": torch.zeros(8, 8)})
    assert torch.equal(r1["w"], w)


def test_elastic_restore_bf16_across_meshes(runs):
    """A bf16 leaf saved beside it, from blocks on (8,): restored onto
    (4, 2) through `restore(shardings=)` and onto one rank, bit for
    bit, and into an f32 target as its values widened."""
    wb = (runs["w"] / 3).to(torch.bfloat16)
    for r in runs["r8"]:
        e = r["elastic"]
        want = local_block(wb, ("model", "data"),
                           Mesh((4, 2), ("data", "model"), rank=e["rank"]))
        assert e["block_bf16"].dtype == torch.bfloat16
        assert torch.equal(e["block_bf16"], want)
    mgr = CheckpointManager(str(runs["tmp"] / "elastic"))
    r1, _ = mgr.restore({"wb": torch.zeros(8, 8, dtype=torch.bfloat16)})
    assert torch.equal(r1["wb"], wb)
    r1, _ = mgr.restore({"wb": torch.zeros(8, 8)})
    assert torch.equal(r1["wb"], wb.float())


@pytest.mark.parametrize("n_heads,n_kv,m", [(12, 2, 4), (8, 2, 4), (12, 4, 6),
                                            (12, 4, 3), (8, 4, 2)])
def test_kv_for_heads_reads_each_query_heads_group(n_heads, n_kv, m):
    """A rank's block of query heads against the K/V heads
    `dist.parallel.kv_for_heads` gives it: attention equal to those heads
    of the one-rank attention, where the block reads a range of whole
    groups (8 over 4 on 2 ranks: K/V split like the queries), lies inside
    one group (12 over 2 and 8 over 2 on 4: K/V held whole), or straddles
    groups (12 over 4 on 6 and on 3: each query head gets its K/V head;
    on 3, rank 2's heads 8-11 read kv heads 2, 3, 3, 3)."""
    from repro_torch.dist.parallel import kv_for_heads
    from repro_torch.dist.sharding import sharding_rules
    from repro_torch.models.attention import _gqa_core

    gen = torch.Generator().manual_seed(0)
    hd, b, t = 4, 2, 5
    q = torch.randn((b, t, n_heads, hd), generator=gen)
    k = torch.randn((b, t, n_kv, hd), generator=gen)
    v = torch.randn((b, t, n_kv, hd), generator=gen)
    whole = _gqa_core(q, k, v, None)
    hl = n_heads // m
    split_kv = n_kv % m == 0
    for rank in range(m):
        mesh = Mesh((1, m), ("data", "model"), rank=rank)
        ks, vs = k, v
        if split_kv:
            kl = n_kv // m
            ks, vs = (x[:, :, rank * kl:(rank + 1) * kl] for x in (k, v))
        with sharding_rules(mesh):
            kr, vr = kv_for_heads(hl, n_heads, n_kv, ks, vs)
        got = _gqa_core(q[:, :, rank * hl:(rank + 1) * hl], kr, vr, None)
        torch.testing.assert_close(
            got, whole[..., rank * hl * hd:(rank + 1) * hl * hd],
            rtol=0, atol=1e-6)


def test_debug_mesh_spans_the_world(runs):
    """`make_debug_mesh(n_model=2)` on 4 ranks: (data, model) = (2, 2),
    row-major, each rank's groups the ranks that differ in one axis."""
    for rank, r in enumerate(runs["r4"]):
        shape, coords, model_ranks, data_ranks = r["debug_mesh"]
        assert shape == {"data": 2, "model": 2}
        assert coords == {"data": rank // 2, "model": rank % 2}
        assert model_ranks == (rank // 2 * 2, rank // 2 * 2 + 1)
        assert data_ranks == (rank % 2, rank % 2 + 2)


@pytest.mark.parametrize("name", ARCHS)
def test_tensor_parallel_train_step_matches_one_rank(runs, name):
    """`make_train_step(mesh=, param_specs=)` on (1, 4), f32, two steps
    at the full lr: each rank trains its blocks (the gradients of
    gathered, cut and head-selected values summed over the ranks where
    each rank used its own part); the blocks gathered back equal the
    one-rank params within training's 1e-4 (a tenth of the lr), the loss
    metrics within 1e-5 and the global grad norm within 1e-5 relative."""
    arch, over = MODELS[name]
    cfg = _config(name, "float32")
    p = copy.deepcopy(runs["tp_masters"][name])
    opt = adamw_init(p)
    step = make_train_step(cfg, AdamWConfig(lr=LR), warmup_steps=0)
    for _ in range(TP_TRAIN_STEPS):
        p, opt, m = step(p, opt, runs["batch"])
    for r in runs["r4"]:
        got = r["tp_train"][name]
        for k in ("loss", "nll", "accuracy"):
            assert abs(got["metrics"][k] - float(m[k])) <= 1e-5, k
        assert abs(got["metrics"]["grad_norm"] - float(m["grad_norm"])) \
            <= 1e-5 * float(m["grad_norm"])
        for (path, a), (_, b) in zip(_leaves(got["params"]), _leaves(p)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-4, err_msg=path)

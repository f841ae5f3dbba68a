"""The port's CUDA kernels on the card, under pytest.

Every test here needs a CUDA device: the kernels have no CPU mode, so
without a card each test skips (decided inside the fixture, never at
import). The module imports no JAX, so it also runs on a machine that
has only the port's dependencies:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: 1e-4 between a paged-attention kernel and its plain
version on valid rows (both fold in f32; they differ in summation order
and in where hd^-0.5 is applied); the bucketed launch and the single
launch are compared bit for bit. Bit-plane kernels: K5 planes equal the
plain pack byte for byte; K3/K4 raw contractions within 1e-5 of
max|raw| of the plain one (products of x with integer weights are exact
in f32, only the summation order differs). The telemetry test holds
the perf model's streamed-byte prediction exactly (error 0) against the
bucketed launches the card runs, and its tokens equal to a drain
without telemetry. Serving tests (paged and dense) hold the greedy f32
tokens with the kernels equal to those with the plain versions.
The IMAGine simulator (plain torch ops, no kernel of its own) gives on
the card the register file and y it gives on the CPU, bit for bit.
K1 and K2 are also held at granite-20b's GQA group of 48 (MQA) and
llava-next-34b's 7, with the same tolerances. The other families
(zamba2, xlstm, whisper, llava) with bit-plane weights give the same
greedy tokens through the kernels as through the plain versions on the
dense cache, the paged cache (whisper, llava) and whisper's
encoder-decoder (logits within 1e-4 there), and K3/K4/K5 hold their
bars at the families' projection shapes (M = 4 included). Training
(no kernel of its own) gives on the card, over three f32 steps, the
params, m and v it gives on the CPU within the stated tolerances. The
distribution layer runs ranks as processes on the one card over gloo:
all-gather, reduce-scatter and permutes of CUDA tensors (staged through
host memory) equal their values, and tensor parallelism on two ranks
(f32, qwen2-1.5b smoke, dense and 8-bit weights through K3/K4) gives the
one rank's greedy tokens, logits within 1e-4. The tools: the dispatch
lint of the probe's real serve steps is clean through K1-K4 under
`set_sync_debug_mode("error")`, and the roofline's counted FLOPs and
kernel bytes of a paged step are the same on `impl="cuda"` as on
`impl="ref"`.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, imagine_u55
from repro_torch.core.gemv_engine import ImagineGemv
from repro_torch.kernels import (
    bitplane_gemm,
    bitplane_gemv,
    ops,
    pack,
    paged_attention,
    paged_prefill,
    ref,
)
from repro_torch.kernels.paged_common import quantize_pages
from repro_torch.models import init_lm
from repro_torch.quant import PimQuantConfig, quantize_tree
from repro_torch.serve import (
    ContinuousBatcher,
    Request,
    ServeConfig,
    ServeEngine,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pools(gen, nb, bs, kv, hd, kind, dev):
    k = torch.randn((nb, bs, kv, hd), generator=gen, device=dev)
    v = torch.randn((nb, bs, kv, hd), generator=gen, device=dev)
    if kind == "int8":
        (kq, ks), (vq, vs) = quantize_pages(k), quantize_pages(v)
        return kq, vq, ks, vs
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    return k.to(dt), v.to(dt), None, None


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_cuda_kernels_match_plain_versions(cuda_device, kind):
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(0)
    B, T, H, KV, hd, bs, nb, mb = 4, 24, 12, 2, 128, 16, 40, 8
    tk, tv, tks, tvs = _pools(gen, nb, bs, KV, hd, kind, dev)
    sc = dict(k_scales=tks, v_scales=tvs)
    rng = np.random.default_rng(0)
    bt = torch.tensor(rng.permutation(np.arange(1, nb))[: B * mb].reshape(
        B, mb), dtype=torch.int32, device=dev)
    lengths = torch.tensor([0, 1, 77, 128], dtype=torch.int32, device=dev)
    q = torch.randn((B, H, hd), generator=gen, device=dev)
    plan, perm = ops.make_bucket_plan(lengths.cpu().numpy(), bs, mb)
    perm = torch.tensor(perm, dtype=torch.int64, device=dev)
    valid = lengths > 0
    for window in (mb * bs, 5):
        out = paged_attention.paged_decode_attention(
            q, tk, tv, bt, lengths, window, **sc)
        plain = ref.paged_attention_ref(q, tk, tv, bt, lengths, window, **sc)
        buck = paged_attention.paged_decode_attention_bucketed(
            q, tk, tv, bt, lengths, window, plan, perm, **sc)
        torch.cuda.synchronize()
        torch.testing.assert_close(out[valid], plain[valid], rtol=1e-4,
                                   atol=1e-4)
        assert torch.equal(buck[valid], out[valid])
    qp = torch.randn((B, T, H, hd), generator=gen, device=dev)
    start = torch.tensor([0, 16, 40, 100], dtype=torch.int32, device=dev)
    total = torch.tensor([20, 30, 64, 124], dtype=torch.int32, device=dev)
    pvalid = (start[:, None] + torch.arange(T, device=dev)[None, :]
              < total[:, None])
    for window in (mb * bs, 9):
        out = paged_prefill.paged_prefill_attention(
            qp, tk, tv, bt, start, total, window, **sc)
        plain = ref.paged_prefill_ref(qp, tk, tv, bt, start, total, window,
                                      **sc)
        torch.cuda.synchronize()
        torch.testing.assert_close(out[pvalid], plain[pvalid], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    dev = cuda_device
    q = torch.zeros((1, 2, 8), device=dev)
    pools = torch.zeros((3, 4, 1, 8), device=dev)
    bt = torch.ones((1, 2), dtype=torch.int32, device=dev)
    ln = torch.ones((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        paged_attention.paged_decode_attention(q, pools, pools, bt.long(),
                                               ln, 8)
    with pytest.raises(ValueError, match="hd=512"):
        big = torch.zeros((3, 4, 1, 512), device=dev)
        paged_attention.paged_decode_attention(
            torch.zeros((1, 2, 512), device=dev), big, big, bt, ln, 8)
    with pytest.raises(ValueError, match="lies on"):
        paged_attention.paged_decode_attention(q, pools.cpu(), pools, bt,
                                               ln, 8)


@pytest.mark.gpu
def test_serving_on_the_card_launches_kernels_and_matches_plain(cuda_device):
    """A small f32 drain through the CUDA kernels equals the same drain
    through the plain versions on the card, and counts its launches."""
    dev = cuda_device
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
               for n in rng.integers(4, 30, 6)]
    out = {}
    for impl in ("cuda", "ref"):
        paged_attention.LAUNCHES = paged_prefill.LAUNCHES = 0
        cb = ContinuousBatcher(cfg, params, n_slots=3, cache_len=48,
                               paged=True, block_size=4, kernel_impl=impl,
                               device=dev)
        for uid, p in enumerate(prompts):
            cb.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        out[impl] = cb.run_until_drained()
        launched = paged_attention.LAUNCHES, paged_prefill.LAUNCHES
        if impl == "cuda":
            assert launched[0] > 0 and launched[1] > 0
        else:
            assert launched == (0, 0)
    assert out["cuda"] == out["ref"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,extra", [
    ("qwen2-1.5b", {}),
    ("gemma3-27b", {"prefill_chunk": 8, "group_blocks": "auto"}),
])
def test_telemetry_on_the_card_predicts_bucketed_launches(cuda_device, arch,
                                                          extra):
    """A telemetry-on drain through the CUDA kernels with pow2 plans:
    the perf model predicts every launch's streamed bytes exactly
    (model error 0, bucketed plans among them), each new step signature
    reaches the watcher, and the tokens equal a telemetry-off drain's."""
    from repro_torch.obs import ManualClock, ServeTelemetry
    from repro_torch.serve.compiled import trace_count

    dev = cuda_device
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
               for n in rng.integers(4, 40, 8)]
    out = {}
    for tel in (None, ServeTelemetry(clock=ManualClock())):
        cb = ContinuousBatcher(cfg, params, n_slots=3, cache_len=56,
                               paged=True, block_size=4, telemetry=tel,
                               bucket_strategy="pow2", device=dev, **extra)
        for uid, p in enumerate(prompts):
            cb.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        before = trace_count()
        out[tel is None] = cb.run_until_drained()
    perf = tel.perf.summary()
    assert out[True] == out[False]
    assert perf["model_error_max"] == 0.0
    assert any(plans is not None for _, plans, _, _ in tel.perf.launch_log)
    assert perf["phases"]["decode"]["launches"] > 0
    assert tel.compile_watcher().total == trace_count() - before
    assert tel.lifecycle_counts() == {"submitted": 8, "finished": 8}


@pytest.mark.gpu
@pytest.mark.parametrize("n_bits,group", [(8, 1), (4, 2), (8, 4), (3, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bitplane_kernels_match_plain_versions(cuda_device, n_bits, group,
                                                dtype):
    """K5 byte-identical to the plain pack; K3 (B <= 512) and K4 (B > 512)
    within 1e-5 of max|raw| of the plain contraction, on a K8 and an M
    that no tile of the kernels divides."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(1)
    k, m = 200, 101
    w = torch.randn((k, m), generator=gen, device=dev)
    planes, scale = ops.quantize_and_pack(w, n_bits, group, "cuda")
    w_q, want_scale = ref.quantize_ref(w, n_bits)
    assert torch.equal(planes, ref.pack_ref(w_q, n_bits, group))
    assert torch.equal(scale, want_scale)
    u = ref.offset_form_ref(planes, group).float()
    for b, mod in ((3, bitplane_gemv), (512, bitplane_gemv),
                   (513, bitplane_gemm)):
        x = torch.randn((b, k), generator=gen, device=dev).to(dtype)
        x_r = ref.prepare_x_ref(x, group).contiguous()
        before = mod.LAUNCHES
        raw = ops.bitplane_kernel(b)(x_r, planes, n_bits=n_bits, group=group)
        plain = x.float() @ u
        torch.cuda.synchronize()
        assert mod.LAUNCHES == before + 1
        err = float((raw - plain).abs().max() / plain.abs().max())
        assert err <= 1e-5, (b, err)


@pytest.mark.gpu
def test_quantized_serving_on_the_card_matches_plain(cuda_device):
    """An f32 drain with 8-bit bit-plane weights through K1-K5 equals the
    same drain through the plain versions on the card."""
    dev = cuda_device
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    pack.LAUNCHES = 0
    qparams = quantize_tree(params, PimQuantConfig(min_features=1))
    assert pack.LAUNCHES == 7 * cfg.n_layers
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
               for n in rng.integers(4, 30, 6)]
    out = {}
    for impl in ("cuda", "ref"):
        bitplane_gemv.LAUNCHES = 0
        cb = ContinuousBatcher(cfg, qparams, n_slots=3, cache_len=48,
                               paged=True, block_size=4, kernel_impl=impl,
                               device=dev)
        for uid, p in enumerate(prompts):
            cb.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        out[impl] = cb.run_until_drained()
        assert (bitplane_gemv.LAUNCHES > 0) == (impl == "cuda")
    assert out["cuda"] == out["ref"]


@pytest.mark.gpu
@pytest.mark.parametrize("n_bits,group", [(8, 1), (4, 2)])
def test_dense_serving_on_the_card_matches_plain(cuda_device, n_bits, group):
    """Dense `generate` (prefill of 2 x 300 rows > 512: K4; decode of 2
    rows: K3) and a dense `ContinuousBatcher` drain, f32 with bit-plane
    weights: kernels on the card give the plain versions' tokens."""
    dev = cuda_device
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    qparams = quantize_tree(params, PimQuantConfig(n_bits=n_bits, group=group,
                                                   min_features=1))
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (2, 300), dtype=np.int32)
    out, drained = {}, {}
    for impl in ("cuda", "ref"):
        bitplane_gemv.LAUNCHES = bitplane_gemm.LAUNCHES = 0
        eng = ServeEngine(cfg, qparams, ServeConfig(
            max_cache_len=320, max_new_tokens=8, kernel_impl=impl,
            device=str(dev)))
        out[impl] = eng.generate(prompts).cpu()
        launched = (bitplane_gemv.LAUNCHES, bitplane_gemm.LAUNCHES)
        assert (min(launched) > 0) == (impl == "cuda"), launched
        assert max(launched) == 0 or impl == "cuda", launched
        cb = ContinuousBatcher(cfg, qparams, n_slots=2, cache_len=48,
                               prompt_len=16, kernel_impl=impl, device=dev)
        for uid in range(4):
            cb.submit(Request(uid=uid, prompt=prompts[uid % 2, :16],
                              max_new_tokens=6))
        drained[impl] = cb.run_until_drained()
    assert torch.equal(out["cuda"], out["ref"])
    assert drained["cuda"] == drained["ref"]


def _prefill_case(gen, dev, kind, q_dtype, B, T, H, KV, hd, bs, mb):
    """Pools, a permuted table and q for one K2 launch shape."""
    nb = B * mb + 1
    tk, tv, tks, tvs = _pools(gen, nb, bs, KV, hd, kind, dev)
    perm = torch.randperm(nb - 1, generator=gen, device=dev)[: B * mb] + 1
    bt = perm.reshape(B, mb).to(torch.int32)
    q = torch.randn((B, T, H, hd), generator=gen, device=dev).to(q_dtype)
    return q, tk, tv, bt, dict(k_scales=tks, v_scales=tvs)


def _valid_rows(start, total, T):
    dev = start.device
    return (start[:, None] + torch.arange(T, device=dev)[None, :]
            < total[:, None])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mb", [16, 80])
def test_prefill_kernel_every_dtype_pair(cuda_device, kind, q_dtype, mb):
    """Every (q, pool) dtype pair the C interface takes goes through the
    tensor-core kernel and stays within 1e-4 of the plain version on
    valid rows, with a full and a sliding window, in one walk (16-page
    table) and split into merged ranges (80 pages)."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(3)
    B, T, H, KV, hd, bs = 2, 90, 12, 2, 128, 16
    q, tk, tv, bt, sc = _prefill_case(gen, dev, kind, q_dtype, B, T, H, KV,
                                      hd, bs, mb)
    start = torch.tensor([0, 130], dtype=torch.int32, device=dev)
    total = torch.tensor([77, 220], dtype=torch.int32, device=dev)
    valid = _valid_rows(start, total, T)
    for window in (mb * bs, 40):
        out = paged_prefill.paged_prefill_attention(q, tk, tv, bt, start,
                                                    total, window, **sc)
        plain = ref.paged_prefill_ref(q, tk, tv, bt, start, total, window,
                                      **sc)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        err = float((out - plain).abs()[valid].max())
        assert err <= 1e-4, (kind, q_dtype, window, err)


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV,hd,bs,T", [
    (12, 2, 128, 16, 37),     # g = 6: 222 units, 3.5 tiles
    (4, 4, 64, 16, 70),       # g = 1: 70 units
    (6, 2, 96, 24, 45),       # hd and bs off the 16-wide tiles
    (2, 1, 16, 4, 29),        # the smoke model's heads and pages
])
def test_prefill_kernel_ragged_tiles(cuda_device, H, KV, hd, bs, T):
    """T and H*T that are not multiples of the 64-unit tile, head
    widths below and between the compiled tile widths, and pages that
    are not a multiple of the 16-key fold step."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(4)
    B, mb = 3, (T + 64) // bs + 2
    q, tk, tv, bt, sc = _prefill_case(gen, dev, "bf16", torch.bfloat16, B, T,
                                      H, KV, hd, bs, mb)
    start = torch.tensor([0, 5, 64], dtype=torch.int32, device=dev)
    total = start + torch.tensor([T, T - 3, 11], dtype=torch.int32,
                                 device=dev)
    valid = _valid_rows(start, total, T)
    for window in (mb * bs, 7):
        out = paged_prefill.paged_prefill_attention(q, tk, tv, bt, start,
                                                    total, window, **sc)
        plain = ref.paged_prefill_ref(q, tk, tv, bt, start, total, window,
                                      **sc)
        torch.cuda.synchronize()
        err = float((out - plain).abs()[valid].max())
        assert err <= 1e-4, (H, KV, hd, bs, T, window, err)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("mb", [24, 72])
def test_prefill_kernel_two_launches_equal_one(cuda_device, kind, mb):
    """A suffix prefilled in two launches, the second starting where the
    first stopped, gives the single launch's rows bit for bit: the tiles
    fall on other rows, and a row's output must not depend on its tile
    (24 pages: one walk; 72: three ranges, merged)."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(5)
    B, T, H, KV, hd, bs = 2, 150, 12, 2, 128, 16
    q_dtype = torch.float32 if kind == "f32" else torch.bfloat16
    q, tk, tv, bt, sc = _prefill_case(gen, dev, kind, q_dtype, B, T, H, KV,
                                      hd, bs, mb)
    start = torch.tensor([0, 100], dtype=torch.int32, device=dev)
    total = start + T
    for window in (mb * bs, 50):
        one = paged_prefill.paged_prefill_attention(q, tk, tv, bt, start,
                                                    total, window, **sc)
        t1 = 37
        first = paged_prefill.paged_prefill_attention(
            q[:, :t1].contiguous(), tk, tv, bt, start, start + t1, window,
            **sc)
        second = paged_prefill.paged_prefill_attention(
            q[:, t1:].contiguous(), tk, tv, bt, start + t1, total, window,
            **sc)
        torch.cuda.synchronize()
        assert torch.equal(first, one[:, :t1]), (kind, window)
        assert torch.equal(second, one[:, t1:]), (kind, window)


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", [(1536, 256), (8960, 1536), (200, 101)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bitplane_gemm_main_path_shapes(cuda_device, k, m, dtype):
    """K4 on the narrow [1536->256] and the long-K [8960->1536]
    projections (both split K) and a ragged one: within 1e-5 of max|raw|
    of the plain contraction, and the rows of a 1024-row launch equal
    the same rows of a 513-row launch bit for bit."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(6)
    w = torch.randn((k, m), generator=gen, device=dev)
    planes, _ = ops.quantize_and_pack(w, 8, 1, "cuda")
    u = ref.offset_form_ref(planes, 1).float()
    x = torch.randn((1024, k), generator=gen, device=dev).to(dtype)
    raws = {}
    for b in (1024, 513):
        x_r = ref.prepare_x_ref(x[:b], 1).contiguous()
        before = bitplane_gemm.LAUNCHES
        raws[b] = bitplane_gemm.bitplane_gemm(x_r, planes, n_bits=8, group=1)
        assert bitplane_gemm.LAUNCHES == before + 1
    plain = x.float() @ u
    torch.cuda.synchronize()
    err = float((raws[1024] - plain).abs().max() / plain.abs().max())
    assert err <= 1e-5, (k, m, dtype, err)
    assert torch.equal(raws[1024][:513], raws[513])


def _decode_case(gen, dev, kind, q_dtype, lengths, mb, B=None, H=12, KV=2,
                 hd=128, bs=16):
    """Pools, a permuted table (every slot its own pages) and q for one
    K1 launch shape."""
    b = len(lengths) if B is None else B
    nb = b * mb + 1
    tk, tv, tks, tvs = _pools(gen, nb, bs, KV, hd, kind, dev)
    perm = torch.randperm(nb - 1, generator=gen, device=dev)[: b * mb] + 1
    bt = perm.reshape(b, mb).to(torch.int32)
    q = torch.randn((b, H, hd), generator=gen, device=dev).to(q_dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, tk, tv, bt, ln, dict(k_scales=tks, v_scales=tvs)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_every_dtype_pair(cuda_device, kind, q_dtype):
    """Every (q, pool) dtype pair goes through the split-walk kernel and
    stays within 1e-4 of the plain version on valid rows, with a full
    and a 256-token window, at lengths 0, 1, one page, one page + 1, a
    walk range's boundary (8 chunks of 16 keys) +- 1 and the full
    68-column table."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(7)
    mb, bs = 68, 16
    rng_len = paged_attention.RANGE_CHUNKS * paged_attention.CHUNK_KEYS
    lengths = [0, 1, 16, 17, rng_len - 1, rng_len, rng_len + 1, mb * bs]
    q, tk, tv, bt, ln, sc = _decode_case(gen, dev, kind, q_dtype, lengths,
                                         mb)
    assert paged_attention.decode_ranges(mb, bs)[0] > 1
    valid = ln > 0
    for window in (mb * bs, 256):
        out = paged_attention.paged_decode_attention(q, tk, tv, bt, ln,
                                                     window, **sc)
        plain = ref.paged_attention_ref(q, tk, tv, bt, ln, window, **sc)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        err = float((out - plain).abs()[valid].max())
        assert err <= 1e-4, (kind, q_dtype, window, err)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_decode_kernel_bucketed_and_bounded_walks_equal_single(cuda_device,
                                                               kind):
    """The bucketed launch and depth-bounded launches from `block_start`
    give the single full launch's valid rows bit for bit, with depths
    that cut the walk's ranges mid-way, a full window and a 256-token
    window whose first live blocks are not 0."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(8)
    mb, bs = 68, 16
    lengths = [1, 100, 300, 517, 700, 900, 1000, 1088]
    q_dtype = torch.float32 if kind == "f32" else torch.bfloat16
    q, tk, tv, bt, ln, sc = _decode_case(gen, dev, kind, q_dtype, lengths,
                                         mb)
    lens = np.asarray(lengths)
    valid = ln > 0
    for window in (mb * bs, 256):
        start = np.maximum(lens - window, 0) // bs
        needs = -(-lens // bs) - start
        blk = torch.tensor(start, dtype=torch.int32, device=dev)
        one = paged_attention.paged_decode_attention(q, tk, tv, bt, ln,
                                                     window, **sc)
        plan, perm = ops.make_bucket_plan(lens, bs, mb, needs=needs)
        assert plan is not None
        buck = paged_attention.paged_decode_attention_bucketed(
            q, tk, tv, bt, ln, window, plan,
            torch.tensor(perm, dtype=torch.int64, device=dev),
            block_start=blk, **sc)
        torch.cuda.synchronize()
        assert torch.equal(buck[valid], one[valid]), (kind, window, plan)
        deepest = int(needs.max())
        for depth in sorted({deepest, min(deepest + 3, mb),
                             max(deepest, mb - 5)}):
            bounded = paged_attention.paged_decode_attention(
                q, tk, tv, bt, ln, window, block_start=blk, depth=depth, **sc)
            torch.cuda.synchronize()
            assert torch.equal(bounded[valid], one[valid]), (kind, window,
                                                             depth)


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", [(1536, 256), (1536, 1536), (1536, 8960),
                                 (8960, 1536)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bitplane_gemv_main_path_shapes(cuda_device, k, m, dtype):
    """K3 on qwen2-1.5b's four projection shapes: within 1e-5 of max|raw|
    of the plain contraction at 512 rows, and the rows of an 8-row launch
    equal the same rows of a 1-row and a 512-row launch bit for bit (the
    K split does not move with B, rows never mix)."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(9)
    w = torch.randn((k, m), generator=gen, device=dev)
    planes, _ = ops.quantize_and_pack(w, 8, 1, "cuda")
    u = ref.offset_form_ref(planes, 1).float()
    x = torch.randn((512, k), generator=gen, device=dev).to(dtype)
    raws = {}
    for b in (512, 100, 8, 1):
        x_r = ref.prepare_x_ref(x[:b], 1).contiguous()
        before = bitplane_gemv.LAUNCHES
        raws[b] = bitplane_gemv.bitplane_gemv(x_r, planes, n_bits=8, group=1)
        assert bitplane_gemv.LAUNCHES == before + 1
    plain = x.float() @ u
    torch.cuda.synchronize()
    err = float((raws[512] - plain).abs().max() / plain.abs().max())
    assert err <= 1e-5, (k, m, dtype, err)
    assert torch.equal(raws[512][:100], raws[100])
    assert torch.equal(raws[512][:8], raws[8])
    assert torch.equal(raws[8][:1], raws[1])


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV,hd,bs,kind", [
    (12, 2, 128, 16, "int8"),   # the main path's heads, int8 pools
    (16, 1, 256, 64, "f32"),    # g = 16, widest head and page: one stage
    (4, 4, 64, 24, "bf16"),     # g = 1; pages of 1.5 fold chunks
    (6, 2, 96, 4, "f32"),       # hd between the compiled widths
    (2, 1, 16, 4, "bf16"),      # the smoke model's heads and pages
    (4, 2, 4, 8, "bf16"),       # rows of 8 bytes: staged by plain loads
    (48, 1, 128, 16, "int8"),   # granite-20b: g = 48, three head tiles
    (20, 1, 64, 16, "f32"),     # g = 20: a full and a 4-head tile
    (40, 8, 128, 16, "bf16"),   # qwen2.5-14b / llama4-scout: g = 5
])
def test_decode_kernel_ragged_shapes(cuda_device, H, KV, hd, bs, kind):
    """Head groups of 1 to 48, head widths below and between the
    compiled tile widths, pages that are not a multiple of the 16-key
    fold step and rows too short for 16-byte copies: within 1e-4 of the
    plain version on valid rows, with a full and a short window."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(10)
    mb = 40
    cap = mb * bs
    lengths = [0, 1, bs, bs + 1, 129, cap // 2 + 3, cap - 3, cap]
    q_dtype = torch.float32 if kind == "f32" else torch.bfloat16
    q, tk, tv, bt, ln, sc = _decode_case(gen, dev, kind, q_dtype, lengths,
                                         mb, H=H, KV=KV, hd=hd, bs=bs)
    valid = ln > 0
    for window in (cap, 7):
        out = paged_attention.paged_decode_attention(q, tk, tv, bt, ln,
                                                     window, **sc)
        plain = ref.paged_attention_ref(q, tk, tv, bt, ln, window, **sc)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        err = float((out - plain).abs()[valid].max())
        assert err <= 1e-4, (H, KV, hd, bs, kind, window, err)


# gemma3-27b's heads and pages: 32 query heads over 16 KV heads (g = 2),
# hd 128, 16-token pages, a 1024-token window; 212 columns of table is
# the full-width drain's (3392 tokens of capacity)
G3_H, G3_KV, G3_HD, G3_BS, G3_MB, G3_WINDOW = 32, 16, 128, 16, 212, 1024


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_gemma3_decode_bucketed_and_bounded_walks_equal_single(cuda_device,
                                                               kind):
    """K1 at g = 2 over 8 slots on the windowed layers' table (walks from
    each slot's first live block) and the global layers' (from 0): within
    1e-4 of the plain version, and bucketed and depth-bounded launches
    equal the single launch bit for bit."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(11)
    lengths = [1, 300, 1023, 1024, 1025, 2000, 3000, 3136]
    q, tk, tv, bt, ln, sc = _decode_case(
        gen, dev, kind, torch.bfloat16, lengths, G3_MB, H=G3_H, KV=G3_KV,
        hd=G3_HD, bs=G3_BS)
    lens = np.asarray(lengths)
    for window in (G3_WINDOW, G3_MB * G3_BS):
        # a windowed group retires the blocks fully behind the query
        start = np.maximum(lens - window, 0) // G3_BS
        needs = np.maximum(-(-lens // G3_BS) - start, 1)
        blk = torch.tensor(start, dtype=torch.int32, device=dev)
        one = paged_attention.paged_decode_attention(
            q, tk, tv, bt, ln, window, block_start=blk, **sc)
        plain = ref.paged_attention_ref(q, tk, tv, bt, ln, window, **sc)
        plan, perm = ops.make_bucket_plan(lens, G3_BS, G3_MB, needs=needs)
        assert plan is not None
        buck = paged_attention.paged_decode_attention_bucketed(
            q, tk, tv, bt, ln, window, plan,
            torch.tensor(perm, dtype=torch.int64, device=dev),
            block_start=blk, **sc)
        torch.cuda.synchronize()
        err = float((one - plain).abs().max())
        assert err <= 1e-4, (kind, window, err)
        assert torch.equal(buck, one), (kind, window, plan)
        deepest = int(needs.max())
        for depth in sorted({deepest, min(deepest + 9, G3_MB)}):
            bounded = paged_attention.paged_decode_attention(
                q, tk, tv, bt, ln, window, block_start=blk, depth=depth, **sc)
            torch.cuda.synchronize()
            assert torch.equal(bounded, one), (kind, window, depth)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_gemma3_prefill_bucketed_and_bounded_walks_equal_single(cuda_device,
                                                                kind):
    """K2 at g = 2 on 512-token chunks (the drains' `prefill_chunk`) of
    three slots starting at 0, 1024 and 2560, windowed and global: within
    1e-4 of the plain version on valid rows, and bucketed and
    depth-bounded launches from the first live block equal the single
    launch bit for bit."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(12)
    T = 512
    q, tk, tv, bt, sc = _prefill_case(gen, dev, kind, torch.bfloat16, 3, T,
                                      G3_H, G3_KV, G3_HD, G3_BS, G3_MB)
    starts = np.asarray([0, 1024, 2560])
    totals = starts + np.asarray([T, T, 300])
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    total = torch.tensor(totals, dtype=torch.int32, device=dev)
    valid = _valid_rows(start, total, T)
    for window in (G3_WINDOW, G3_MB * G3_BS):
        first = np.maximum(starts - window + 1, 0) // G3_BS
        needs = np.maximum(-(-totals // G3_BS) - first, 1)
        blk = torch.tensor(first, dtype=torch.int32, device=dev)
        one = paged_prefill.paged_prefill_attention(
            q, tk, tv, bt, start, total, window, block_start=blk, **sc)
        plain = ref.paged_prefill_ref(q, tk, tv, bt, start, total, window,
                                      **sc)
        plan, perm = ops.make_bucket_plan(totals, G3_BS, G3_MB, needs=needs)
        assert plan is not None
        buck = paged_prefill.paged_prefill_attention_bucketed(
            q, tk, tv, bt, start, total, window, plan,
            torch.tensor(perm, dtype=torch.int64, device=dev),
            block_start=blk, **sc)
        torch.cuda.synchronize()
        err = float((one - plain).abs()[valid].max())
        assert err <= 1e-4, (kind, window, err)
        assert torch.equal(buck[valid], one[valid]), (kind, window, plan)
        deepest = int(needs.max())
        for depth in sorted({deepest, min(deepest + 9, G3_MB)}):
            bounded = paged_prefill.paged_prefill_attention(
                q, tk, tv, bt, start, total, window, block_start=blk,
                depth=depth, **sc)
            torch.cuda.synchronize()
            assert torch.equal(bounded[valid], one[valid]), (kind, window,
                                                             depth)


# granite-20b's heads and pages: 48 query heads over one KV head (MQA,
# g = 48: three 16-head tiles of K1, 1 1/3 positions a 64-unit tile of
# K2), hd 128, 16-token pages, 68 columns (1088 tokens)
GR_H, GR_KV, GR_HD, GR_BS, GR_MB = 48, 1, 128, 16, 68
#: llava-next-34b's: 56 query heads over 8 KV heads (g = 7)
LL_H, LL_KV = 56, 8


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_granite_g48_decode_bucketed_and_bounded_walks_equal_single(
        cuda_device, kind):
    """K1 at g = 48 over 8 slots: within 1e-4 of the plain version on
    valid rows, with a full and a 256-token window (walks from each
    slot's first live block), and bucketed and depth-bounded launches
    equal the single launch bit for bit."""
    _check_decode_walks(cuda_device, kind, GR_H, GR_KV, 13)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_llava_g7_decode_bucketed_and_bounded_walks_equal_single(
        cuda_device, kind):
    """K1 at llava-next-34b's 56 query heads over 8 KV heads (g = 7), as
    the granite test holds it at g = 48."""
    _check_decode_walks(cuda_device, kind, LL_H, LL_KV, 15)


def _check_decode_walks(dev, kind, h, kv, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = [0, 1, 16, 17, 129, 300, 700, GR_MB * GR_BS]
    q, tk, tv, bt, ln, sc = _decode_case(
        gen, dev, kind, torch.bfloat16, lengths, GR_MB, H=h, KV=kv,
        hd=GR_HD, bs=GR_BS)
    lens = np.asarray(lengths)
    valid = ln > 0
    for window in (GR_MB * GR_BS, 256):
        start = np.maximum(lens - window, 0) // GR_BS
        needs = np.maximum(-(-lens // GR_BS) - start, 1)
        blk = torch.tensor(start, dtype=torch.int32, device=dev)
        one = paged_attention.paged_decode_attention(
            q, tk, tv, bt, ln, window, block_start=blk, **sc)
        plain = ref.paged_attention_ref(q, tk, tv, bt, ln, window, **sc)
        plan, perm = ops.make_bucket_plan(lens, GR_BS, GR_MB, needs=needs)
        assert plan is not None
        buck = paged_attention.paged_decode_attention_bucketed(
            q, tk, tv, bt, ln, window, plan,
            torch.tensor(perm, dtype=torch.int64, device=dev),
            block_start=blk, **sc)
        torch.cuda.synchronize()
        assert torch.isfinite(one).all()
        err = float((one - plain).abs()[valid].max())
        assert err <= 1e-4, (kind, window, err)
        assert torch.equal(buck[valid], one[valid]), (kind, window, plan)
        deepest = int(needs.max())
        for depth in sorted({deepest, min(deepest + 9, GR_MB)}):
            bounded = paged_attention.paged_decode_attention(
                q, tk, tv, bt, ln, window, block_start=blk, depth=depth, **sc)
            torch.cuda.synchronize()
            assert torch.equal(bounded[valid], one[valid]), (kind, window,
                                                             depth)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_granite_g48_prefill_bucketed_walk_equals_single(cuda_device, kind):
    """K2 at g = 48: two slots' 70-token chunks (3,360 units a slot,
    tiles that start inside a position's heads) from starts 0 and 256,
    within 1e-4 of the plain version on valid rows with a full and a
    40-token window; the bucketed launch equals the single one bit for
    bit."""
    _check_prefill_walks(cuda_device, kind, GR_H, GR_KV, 14)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_llava_g7_prefill_bucketed_walk_equals_single(cuda_device, kind):
    """K2 at llava-next-34b's g = 7, as the granite test holds it at
    g = 48."""
    _check_prefill_walks(cuda_device, kind, LL_H, LL_KV, 16)


def _check_prefill_walks(dev, kind, h, kv, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    T = 70
    q, tk, tv, bt, sc = _prefill_case(gen, dev, kind, torch.bfloat16, 2, T,
                                      h, kv, GR_HD, GR_BS, GR_MB)
    starts = np.asarray([0, 256])
    totals = starts + np.asarray([T, 50])
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    total = torch.tensor(totals, dtype=torch.int32, device=dev)
    valid = _valid_rows(start, total, T)
    for window in (GR_MB * GR_BS, 40):
        first = np.maximum(starts - window + 1, 0) // GR_BS
        needs = np.maximum(-(-totals // GR_BS) - first, 1)
        blk = torch.tensor(first, dtype=torch.int32, device=dev)
        one = paged_prefill.paged_prefill_attention(
            q, tk, tv, bt, start, total, window, block_start=blk, **sc)
        plain = ref.paged_prefill_ref(q, tk, tv, bt, start, total, window,
                                      **sc)
        plan, perm = ops.make_bucket_plan(totals, GR_BS, GR_MB, needs=needs)
        assert plan is not None
        buck = paged_prefill.paged_prefill_attention_bucketed(
            q, tk, tv, bt, start, total, window, plan,
            torch.tensor(perm, dtype=torch.int64, device=dev),
            block_start=blk, **sc)
        torch.cuda.synchronize()
        assert torch.isfinite(one).all()
        err = float((one - plain).abs()[valid].max())
        assert err <= 1e-4, (kind, window, err)
        assert torch.equal(buck[valid], one[valid]), (kind, window, plan)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "granite-20b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("quantize", [False, True])
def test_zoo_serving_on_the_card_matches_plain(cuda_device, arch, quantize):
    """The smoke configs of the rest of the zoo in f32, with dense and
    with 8-bit g = 1 bit-plane weights (the MoE expert stacks packed):
    a paged drain through the kernels gives the tokens of the drain
    through the plain versions."""
    dev = cuda_device
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if quantize:
        params = quantize_tree(params, PimQuantConfig(8, 1, min_features=8))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
               for n in rng.integers(4, 30, 6)]
    out = {}
    for impl in ("cuda", "ref"):
        paged_attention.LAUNCHES = paged_prefill.LAUNCHES = 0
        bitplane_gemv.LAUNCHES = 0
        cb = ContinuousBatcher(cfg, params, n_slots=3, cache_len=48,
                               paged=True, block_size=4, kernel_impl=impl,
                               device=dev)
        for uid, p in enumerate(prompts):
            cb.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        out[impl] = cb.run_until_drained()
        launched = (paged_attention.LAUNCHES, paged_prefill.LAUNCHES,
                    bitplane_gemv.LAUNCHES)
        if impl == "cuda":
            assert launched[0] > 0 and launched[1] > 0
            assert (launched[2] > 0) == quantize
        else:
            assert launched == (0, 0, 0)
    assert out["cuda"] == out["ref"]


#: gemma3-27b's projections: wk/wv, wq, wo, w_gate/w_up, w_down
G3_MATRICES = [(5376, 2048), (5376, 4096), (4096, 5376), (5376, 21504),
               (21504, 5376)]


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", G3_MATRICES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bitplane_kernels_gemma3_shapes(cuda_device, k, m, dtype):
    """K3 (8 and 512 rows) and K4 (768 rows) at K8 = 672, 512 and 2688
    and M up to 21504: within 1e-5 of max|raw| of the plain contraction,
    and K3's rows of an 8-row launch equal those of the 512-row one bit
    for bit."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(13)
    w = torch.randn((k, m), generator=gen, device=dev)
    planes, _ = ops.quantize_and_pack(w, 8, 1, "cuda")
    u = ref.offset_form_ref(planes, 1).float()
    del w
    x = torch.randn((768, k), generator=gen, device=dev).to(dtype)
    raws = {}
    for b, mod, fn in ((768, bitplane_gemm, bitplane_gemm.bitplane_gemm),
                       (512, bitplane_gemv, bitplane_gemv.bitplane_gemv),
                       (8, bitplane_gemv, bitplane_gemv.bitplane_gemv)):
        x_r = ref.prepare_x_ref(x[:b], 1).contiguous()
        before = mod.LAUNCHES
        raws[b] = fn(x_r, planes, n_bits=8, group=1)
        assert mod.LAUNCHES == before + 1
    plain = x.float() @ u
    torch.cuda.synchronize()
    for b, raw in raws.items():
        err = float((raw - plain[:b]).abs().max() / plain[:b].abs().max())
        assert err <= 1e-5, (k, m, dtype, b, err)
    assert torch.equal(raws[512][:8], raws[8])


@pytest.mark.gpu
def test_imagine_smoke_gemv_on_card_equals_cpu(cuda_device):
    """The bit-serial walk on the card leaves the same register file,
    y and cycles as on the CPU, over two GEMVs on one engine."""
    rng = np.random.default_rng(0)
    card = ImagineGemv(imagine_u55.smoke(), cuda_device)
    host = ImagineGemv(imagine_u55.smoke(), "cpu")
    assert card.array.rf.device.type == "cuda"
    for m, d in [(5, 16), (8, 32)]:
        w = rng.integers(-128, 128, size=(m, d))
        x = rng.integers(-128, 128, size=(d,))
        y, cycles = card.run_gemv(w, x)
        y_host, cycles_host = host.run_gemv(w, x)
        assert torch.equal(y.cpu(), y_host)
        assert np.array_equal(y_host.numpy(), w @ x)
        assert cycles == cycles_host == card.analytic_cycles(m, d)
        assert torch.equal(card.array.rf.cpu(), host.array.rf)
        assert card.array.instr_count == host.array.instr_count


@pytest.mark.gpu
def test_imagine_u55_gemv_126x512(cuda_device):
    """One pass of the full U55 array (126 x 32 x 16 lanes, depth 1024):
    every block row's GEMV row exact, in 856 cycles."""
    rng = np.random.default_rng(1)
    eng = ImagineGemv(imagine_u55.config(), cuda_device)
    assert eng.array.rf.numel() == 66_060_288
    w = rng.integers(-128, 128, size=(126, 512))
    x = rng.integers(-128, 128, size=(512,))
    y, cycles = eng.run_gemv(w, x)
    assert np.array_equal(y.cpu().numpy(), w @ x)
    assert cycles == eng.analytic_cycles(126, 512) == 856
    assert eng.array.instr_count == 15


# ---------------------------------------------------------------------------
# the other families: zamba2, xlstm, whisper, llava
# ---------------------------------------------------------------------------

FAMILIES = ["zamba2-1.2b", "xlstm-350m", "llava-next-34b", "whisper-medium"]


def _reset_bitplane_counts():
    bitplane_gemv.LAUNCHES = bitplane_gemm.LAUNCHES = pack.LAUNCHES = 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_families_dense_serving_on_the_card_matches_plain(cuda_device,
                                                          arch):
    """The smoke configs in f32 with 8-bit g = 1 bit-plane weights (every
    `w*` leaf packed by K5, xlstm's [D -> H] gates included): dense
    `generate` (3 prompts of 200 tokens: K4 on prefill, K3 on decode)
    and the dense batcher give the same tokens with the kernels as with
    the plain versions."""
    dev = cuda_device
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    _reset_bitplane_counts()
    params = quantize_tree(params, PimQuantConfig(8, 1, min_features=1))
    assert pack.LAUNCHES > 0
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, 200)).astype(np.int32)
    out, drained = {}, {}
    for impl in ("cuda", "ref"):
        _reset_bitplane_counts()
        eng = ServeEngine(cfg, params, ServeConfig(
            max_cache_len=208, max_new_tokens=6, kernel_impl=impl,
            device=str(dev)))
        out[impl] = eng.generate(prompts).cpu()
        cb = ContinuousBatcher(cfg, params, n_slots=2, cache_len=32,
                               kernel_impl=impl, device=dev)
        for uid, p in enumerate(prompts[:, :20]):
            cb.submit(Request(uid=uid, prompt=p, max_new_tokens=5))
        drained[impl] = cb.run_until_drained()
        launched = (bitplane_gemv.LAUNCHES, bitplane_gemm.LAUNCHES)
        if impl == "cuda":
            assert launched[0] > 0 and launched[1] > 0
        else:
            assert launched == (0, 0)
    assert torch.equal(out["cuda"], out["ref"])
    assert drained["cuda"] == drained["ref"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-medium"])
@pytest.mark.parametrize("quantize", [False, True])
def test_families_paged_drain_on_the_card_matches_plain(cuda_device, arch,
                                                        quantize):
    """The launcher's --paged drain for the attention families: tokens
    with K1/K2 (and K3 with bit-plane weights) equal those with the
    plain versions."""
    dev = cuda_device
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if quantize:
        params = quantize_tree(params, PimQuantConfig(8, 1, min_features=1))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
               for n in rng.integers(4, 30, 6)]
    out = {}
    for impl in ("cuda", "ref"):
        paged_attention.LAUNCHES = paged_prefill.LAUNCHES = 0
        bitplane_gemv.LAUNCHES = 0
        cb = ContinuousBatcher(cfg, params, n_slots=3, cache_len=48,
                               paged=True, block_size=4, prefix=True,
                               kernel_impl=impl, device=dev)
        for uid, p in enumerate(prompts):
            cb.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        out[impl] = cb.run_until_drained()
        launched = (paged_attention.LAUNCHES, paged_prefill.LAUNCHES,
                    bitplane_gemv.LAUNCHES)
        if impl == "cuda":
            assert launched[0] > 0 and launched[1] > 0
            assert (launched[2] > 0) == quantize
        else:
            assert launched == (0, 0, 0)
    assert out["cuda"] == out["ref"]


@pytest.mark.gpu
def test_whisper_encdec_on_the_card_matches_plain(cuda_device):
    """whisper's encoder-decoder (smoke, f32) with 8-bit g = 1 weights:
    `prefill_encdec` over 300 stub frames (K4 on the encoder's 600 rows)
    and 6 greedy `decode_step_encdec`s (K3) give the plain versions'
    tokens, the logits within 1e-4."""
    from repro_torch.models import (decode_step_encdec, init_encdec,
                                    prefill_encdec)
    from repro_torch.models.frontend_stub import make_stub_embeddings

    dev = cuda_device
    cfg = dataclasses.replace(get_config("whisper-medium", smoke=True),
                              dtype="float32")
    params = quantize_tree(
        init_encdec(cfg, torch.Generator(device=dev).manual_seed(0), dev),
        PimQuantConfig(8, 1, min_features=1))
    frames = make_stub_embeddings(cfg, 2, 300, seed=1, device=dev)
    prompt = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32,
                          device=dev)
    runs = {}
    for impl in ("cuda", "ref"):
        _reset_bitplane_counts()
        logits, cache = prefill_encdec(params, frames, prompt, cfg, 16,
                                       impl=impl)
        steps = [logits]
        for _ in range(6):
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            logits, cache = decode_step_encdec(params, tok, cache, cfg,
                                               impl=impl)
            steps.append(logits)
        runs[impl] = torch.cat(steps, dim=1)
        launched = (bitplane_gemv.LAUNCHES, bitplane_gemm.LAUNCHES)
        assert (launched[0] > 0 and launched[1] > 0 if impl == "cuda"
                else launched == (0, 0))
    torch.cuda.synchronize()
    assert torch.equal(runs["cuda"].argmax(-1), runs["ref"].argmax(-1))
    assert float((runs["cuda"] - runs["ref"]).abs().max()) <= 1e-4


#: the families' projections at published width: zamba2's w_in and
#: w_out, xlstm's gates, q/k/v and down projections, whisper's MLP
FAMILY_MATRICES = [(2048, 8352), (4096, 2048), (1024, 4), (1024, 2048),
                   (2048, 1024), (1024, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("k,m", FAMILY_MATRICES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bitplane_kernels_family_shapes(cuda_device, k, m, dtype):
    """K5 byte-identical to the plain pack, K3 (8 rows) and K4 (2048
    rows) within 1e-5 of max|raw| of the plain contraction, at the
    families' projection shapes (M = 4 included)."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(17)
    w = torch.randn((k, m), generator=gen, device=dev)
    w_q, scale = ref.quantize_ref(w, 8)
    planes, got_scale = ops.quantize_and_pack(w, 8, 1, "cuda")
    torch.cuda.synchronize()
    assert torch.equal(planes, ref.pack_ref(w_q, 8, 1))
    assert torch.equal(got_scale, scale)
    u = ref.offset_form_ref(planes, 1).float()
    x = torch.randn((2048, k), generator=gen, device=dev).to(dtype)
    plain = x.float() @ u
    for b, fn in ((2048, bitplane_gemm.bitplane_gemm),
                  (8, bitplane_gemv.bitplane_gemv)):
        raw = fn(ref.prepare_x_ref(x[:b], 1).contiguous(), planes, n_bits=8,
                 group=1)
        torch.cuda.synchronize()
        err = float((raw - plain[:b]).abs().max() / plain[:b].abs().max())
        assert err <= 1e-5, (k, m, dtype, b, err)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "phi3.5-moe-42b-a6.6b",
                                  "zamba2-1.2b"])
def test_train_steps_on_the_card_match_the_cpu(cuda_device, arch):
    """Three f32 `make_train_step` steps (remat on, TF32 off) on the card
    and on the CPU from the same f32 masters: the loss within 1e-5,
    params within a tenth of the lr (early AdamW updates are near
    lr * sign(g)), m and v within 1e-5 of their largest value. No serving
    kernel launches on the training path."""
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_items, tree_map
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                              remat=True)
    cpu = init_lm(cfg, torch.Generator().manual_seed(0), "cpu",
                  param_dtype=torch.float32)
    card = tree_map(lambda x: x.to(cuda_device, copy=True), cpu)
    lr = 1e-3
    step = make_train_step(cfg, AdamWConfig(lr=lr), warmup_steps=0,
                           total_steps=10)
    states = {"cpu": (cpu, adamw_init(cpu)), "card": (card, adamw_init(card))}
    before = {name: mod.LAUNCHES for name, mod in (
        ("k1", paged_attention), ("k2", paged_prefill), ("k3", bitplane_gemv),
        ("k4", bitplane_gemm), ("k5", pack))}
    dc = DataConfig(cfg.vocab_size, 16, 4)
    for s in range(3):
        tokens, targets = batch_at(dc, s)
        losses = {}
        for name, (params, opt) in states.items():
            dev = params["embed"].device
            batch = {"tokens": torch.from_numpy(tokens).to(dev),
                     "targets": torch.from_numpy(targets).to(dev)}
            params, opt, m = step(params, opt, batch)
            states[name] = (params, opt)
            losses[name] = float(m["loss"])
        assert abs(losses["card"] - losses["cpu"]) <= 1e-5, (s, losses)
    (pc, oc), (pp, op) = states["card"], states["cpu"]
    for got, want, tol in ((pc, pp, 0.1 * lr), (oc.m, op.m, None),
                           (oc.v, op.v, None)):
        for (path, g), (_, w) in zip(tree_items(got), tree_items(want)):
            atol = tol if tol is not None else 1e-5 * float(w.abs().max())
            err = float((g.cpu() - w).abs().max())
            assert err <= atol, (path, err, atol)
    assert before == {name: mod.LAUNCHES for name, mod in (
        ("k1", paged_attention), ("k2", paged_prefill), ("k3", bitplane_gemv),
        ("k4", bitplane_gemm), ("k5", pack))}


TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.gpu
def test_staged_collectives_on_the_card(cuda_device):
    from repro_torch.dist import spawn

    r0, r1 = spawn.run("torch_dist_cases:card_collectives_rank", 2,
                       timeout=120, paths=[TESTS])
    x = [torch.arange(8, dtype=torch.float32) + 10 * r for r in range(2)]
    for rank, r in enumerate((r0, r1)):
        assert torch.equal(r["all_gather"], torch.cat(x))
        assert torch.equal(r["reduce_scatter"],
                           (x[0] + x[1]).chunk(2)[rank])
        assert torch.equal(r["ppermute"], x[1 - rank])
        assert torch.equal(r["all_reduce"], x[0] + x[1])
        assert r["staged"] >= 3


@pytest.mark.gpu
@pytest.mark.parametrize("quantize", [False, True])
def test_tensor_parallel_on_the_card_matches_one_rank(cuda_device, quantize):
    from repro_torch.dist import spawn
    from repro_torch.models import decode_step, forward, prefill

    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              dtype="float32")
    params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    if quantize:
        params = quantize_tree(params, PimQuantConfig(n_bits=8, group=1,
                                                      min_features=1))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    r0, r1 = spawn.run("torch_dist_cases:card_tp_rank", 2, args=(
        params, "qwen2-1.5b", tokens, 24, 6), timeout=120, paths=[TESTS])
    with torch.no_grad():
        logits = forward(params, tokens, cfg)[0]
        out, cache = prefill(params, tokens, cfg, 24)
        greedy = [out[:, -1].argmax(-1)]
        for _ in range(5):
            out, cache = decode_step(params, greedy[-1][:, None], cache, cfg)
            greedy.append(out[:, -1].argmax(-1))
    one = torch.stack(greedy, 1)
    for r in (r0, r1):
        assert torch.equal(r["tokens"], one)
        assert float((r["logits"] - logits).abs().max()) <= 1e-4
        if quantize:
            assert r["k3"] > 0 and r["k4"] == 0


@pytest.mark.gpu
def test_dispatch_lint_of_the_smoke_steps_is_clean_on_the_card(cuda_device):
    """The probe's real decode and prefill steps (bf16 and int8 pools,
    8-bit weights) through K1-K4, under set_sync_debug_mode("error")."""
    from repro_torch.analysis.dispatch_lint import lint_serve_steps

    before = {m: m.LAUNCHES for m in (paged_attention, paged_prefill,
                                      bitplane_gemv)}
    assert lint_serve_steps(device="cuda", impl="cuda") == []
    assert all(m.LAUNCHES > n for m, n in before.items())


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "pim8"])
def test_counted_work_equal_on_both_routes(cuda_device, quantized):
    """A paged decode and prefill step of qwen2-1.5b smoke counts the
    same FLOPs and kernel bytes on impl="cuda" as on impl="ref"."""
    from repro_torch.analysis.dispatch_lint import probe_steps
    from repro_torch.launch.roofline import count_step

    cfg = get_config("qwen2-1.5b", smoke=True)
    params = init_lm(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                     cuda_device)
    if quantized:
        params = quantize_tree(params, PimQuantConfig(n_bits=8, group=1,
                                                      min_features=1))
    counts = {}
    with torch.no_grad():
        for impl in ("cuda", "ref"):
            for name, fn, _ in probe_steps(
                    cfg, params, cuda_device, impl=impl, n_slots=4,
                    lengths=(40, 17, 64, 3), prompt=32, cached=16,
                    block_size=16, max_len=65):
                counts[impl, name] = count_step(fn)[1]
    for name in ("decode", "prefill"):
        a, b = counts["cuda", name], counts["ref", name]
        assert a["flops"] == b["flops"] and a["kernel_flops"] > 0
        assert a["kernel_bytes"] == b["kernel_bytes"]
        assert {k: v["calls"] for k, v in a["kernels"].items()} == \
            {k: v["calls"] for k, v in b["kernels"].items()}

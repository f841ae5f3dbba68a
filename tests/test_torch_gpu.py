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
in f32, only the summation order differs), and K3's rows bit for bit
across B, its wide tile (wgmma) against its narrow one (mma.sync). The
telemetry test holds the perf model's streamed-byte prediction exactly
(error 0) against the bucketed launches the card runs, and its tokens
equal to a drain without telemetry. Serving tests (paged and dense) hold the greedy f32
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
    bitplane_grouped,
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
    K split does not move with B, rows never mix, and the wide tile that
    takes 100 and 512 rows gives the narrow tile's bits)."""
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
@pytest.mark.parametrize("k,m", [(6144, 6144), (6144, 128), (6144, 24576),
                                 (24576, 6144)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bitplane_gemv_wide_tile_equals_narrow(cuda_device, k, m, dtype):
    """K3 on granite-20b's projection shapes ([6144 -> 6144] q and o,
    [6144 -> 128] k and v, [6144 -> 24576] up, [24576 -> 6144] down):
    every row of a launch of B rows, B in {187, 128, 65, 64, 25, 24, 16,
    1}, equals the same row of every other launch bit for bit, so the
    wide tile (B > 24) gives the narrow tile's bits; and within 1e-5 of
    max|raw| of the plain contraction. `LAUNCHES_WIDE` counts the
    launches above 24 rows and only those."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(k + m)
    planes = torch.randint(0, 256, (8, k // 8, m), generator=gen,
                           device=dev, dtype=torch.uint8)
    x = torch.randn((187, k), generator=gen, device=dev).to(dtype)
    raws = {}
    for b in (187, 128, 65, 64, 25, 24, 16, 1):
        x_r = ref.prepare_x_ref(x[:b], 1).contiguous()
        before = (bitplane_gemv.LAUNCHES, bitplane_gemv.LAUNCHES_WIDE)
        raws[b] = bitplane_gemv.bitplane_gemv(x_r, planes, n_bits=8)
        assert (bitplane_gemv.LAUNCHES, bitplane_gemv.LAUNCHES_WIDE) == (
            before[0] + 1, before[1] + (b > 24))
    plain = x.float() @ ref.offset_form_ref(planes, 1).float()
    torch.cuda.synchronize()
    err = float((raws[187] - plain).abs().max() / plain.abs().max())
    assert err <= 1e-5, (k, m, dtype, err)
    for b, raw in raws.items():
        assert torch.equal(raw, raws[187][:b]), b


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


# ---------------------------------------------------------------------------
# the paged decode step from piecewise CUDA graphs (serve/graphs.py)
# ---------------------------------------------------------------------------

def _graph_prompts(vocab, n=10, seed=4):
    """Ragged prompts (some longer than a prefill chunk of 8, so their
    slot is parked while it prefills) and outputs of 2-12 tokens, so
    slots free and refill through the drain."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(n_p), dtype=np.int32), int(n_new))
            for n_p, n_new in zip(rng.integers(3, 30, n),
                                  rng.integers(2, 13, n))]


#: where `_moe_read` puts the decode's MoE outputs: the list of the
#: batcher whose decode step runs
_MOE_SINK = [None]


def _moe_read(inner):
    """`moe_forward`, each decode call's output read through
    `serve.graphs.each_run` into the `_MOE_SINK` of the step that runs
    when the reading is made (a replay's, for a captured call)."""
    from repro_torch.serve.graphs import each_run

    def counted(params, x, **kw):
        y, aux = inner(params, x, **kw)
        if x.shape[1] == 1 and _MOE_SINK[0] is not None:
            each_run(lambda: _MOE_SINK[0].append(y.clone()))
        return y, aux
    return counted


def _recording(cb, step, log):
    """`step`, logging each decode's logits with the rows that decoded
    and the MoE outputs `_moe_read` read in it."""
    def call(*args, **kw):
        moe = _MOE_SINK[0] = []
        try:
            out = step(*args, **kw)
        finally:
            _MOE_SINK[0] = None
        rows = [i for i, s in enumerate(cb.slots)
                if s is not None and i not in cb._chunk_pos]
        log.append((out[0].clone(), rows, moe))
        return out
    return call


def _graph_counts(tel):
    """(captures, replays) of the paged decode graphs, from the
    telemetry's registry (0 where a counter was never made)."""
    return tuple(sum(m.value for m in tel.registry.find(
        f"serve_decode_graph_{kind}")) for kind in ("captures", "replays"))


def _pool_tensors(pc, page0=False):
    """Every pool stack, without scratch page 0 unless `page0`: idle and
    parked slots all write its first row in one scatter, whose duplicate
    indices land in no fixed order unless index_put is made to sort them
    (`torch.use_deterministic_algorithms`), on either route."""
    stacks = [pc.k_pages, pc.v_pages]
    if pc.quantized:
        stacks += [pc.k_scales, pc.v_scales]
    return [s if page0 else s[:, 1:] for s in stacks]


def _graphed_and_eager(dev, cfg, params, prompts, telemetry=None,
                       replace_pool_at=None, whole=False, n_slots=3, **kw):
    """One drain with the decode step graphed, one with it eager, in
    lockstep: after each tick, the decoded rows' logits and tokens, their
    rows of each MoE output `_moe_read` read, and both pools (scales
    included) are equal bit for bit, each kernel module's `LAUNCHES`
    and K3's `LAUNCHES_WIDE` (`serve.graphs.COUNTERS`) grew alike, and
    at the end the finished requests' tokens are equal. Idle and parked
    rows read scratch page 0 (`_pool_tensors`), so their rows and page 0
    are left out, unless `whole` (for a run whose index_put sorts).
    `n_slots` sets the decode's rows. Returns the graphed and the eager
    decode step, the ticks and the decodes."""
    from repro_torch.serve.graphs import COUNTERS

    runs = {}
    for graphed in (True, False):
        cb = ContinuousBatcher(cfg, params, n_slots=n_slots, cache_len=64,
                               paged=True, block_size=4, device=dev,
                               telemetry=telemetry if graphed else None,
                               **kw)
        step = cb._decode_paged
        if not graphed:
            step.graphs = None
        log = []
        cb._decode_paged = _recording(cb, step, log)
        for uid, (p, n_new) in enumerate(prompts):
            cb.submit(Request(uid=uid, prompt=p, max_new_tokens=n_new))
        runs[graphed] = (cb, step, log)
    (a, step, log_a), (b, eager, log_b) = runs[True], runs[False]
    ticks = 0
    while a.queue or any(s is not None for s in a.slots):
        if ticks == replace_pool_at:
            for cb in (a, b):
                cb.pcache.k_pages = cb.pcache.k_pages.clone()
        launched = []
        for cb in (a, b):
            before = [getattr(m, c) for m, c in COUNTERS]
            cb.step()
            launched.append([getattr(m, c) - n
                             for (m, c), n in zip(COUNTERS, before)])
        assert launched[0] == launched[1]
        ticks += 1
        assert len(log_a) == len(log_b)
        if log_a:
            (la, ra, ma), (lb, rb, mb) = log_a[-1], log_b[-1]
            assert ra == rb
            if whole:
                ra = rb = list(range(a.n_slots))
            assert torch.equal(la[ra], lb[rb])
            assert torch.equal(a.tokens[ra], b.tokens[rb])
            assert len(ma) == len(mb) == (cfg.n_layers if cfg.n_experts
                                          else 0)
            assert all(torch.equal(x[ra], y[rb]) for x, y in zip(ma, mb))
        for x, y in zip(_pool_tensors(a.pcache, whole),
                        _pool_tensors(b.pcache, whole)):
            assert torch.equal(x, y)
    assert not (b.queue or any(s is not None for s in b.slots))
    assert a.finished == b.finished
    return step, eager, ticks, len(log_a)


GRAPH_CASES = {
    "qwen2-1.5b": dict(prefill_chunk=8),
    "gemma3-27b": dict(prefill_chunk=8, group_blocks="auto"),
    "phi3.5-moe-42b-a6.6b": dict(prefill_chunk=8),
    # dropless top-4 of 8 experts (K6 on pim8), windowed and YaRN layers
    "mellum2-12b-a2.5b": dict(prefill_chunk=8, group_blocks="auto"),
}


#: (arch, quantize) of the bit-for-bit graph test: a dense dropless
#: expert stack is refused on the card (`models.moe._grouped_matmul`)
GRAPH_WEIGHTS = [pytest.param(arch, q, id=f"{arch}-{'pim8' if q else 'dense'}")
                 for arch in GRAPH_CASES for q in (False, True)
                 if q or get_config(arch, smoke=True).capacity_factor > 0]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch,quantize", GRAPH_WEIGHTS)
def test_graphed_decode_equals_eager_bit_for_bit(cuda_device, monkeypatch,
                                                 arch, quantize, kv_dtype):
    """Over 20+ ticks with slot turnover and parked chunked-prefill slots,
    on bf16 and int8 pools, with dense and 8-bit bit-plane weights, the
    decode served from its CUDA graphs gives the eager step's logits,
    tokens and pools bit for bit: a dense stack, gemma3's two layer
    groups with a window, and a MoE. One capture serves the drain, the
    first decode runs eagerly and every decode after the second is a
    replay. Each kernel launches as often, and a MoE output read through
    `serve.graphs.each_run` is read at every decode, replayed or not."""
    from repro_torch.models import transformer
    from repro_torch.obs import ManualClock, ServeTelemetry

    dev = cuda_device
    cfg = get_config(arch, smoke=True)
    monkeypatch.setattr(transformer, "moe_forward",
                        _moe_read(transformer.moe_forward))

    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if quantize:
        params = quantize_tree(params, PimQuantConfig(8, 1, min_features=8))
    tel = ServeTelemetry(clock=ManualClock())
    _, _, ticks, decodes = _graphed_and_eager(
        dev, cfg, params, _graph_prompts(cfg.vocab_size), telemetry=tel,
        kv_dtype=kv_dtype, **GRAPH_CASES[arch])
    assert ticks >= 20
    assert _graph_counts(tel) == (1, decodes - 2)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", list(GRAPH_CASES))
def test_graphed_decode_equals_eager_whole_where_index_put_sorts(
        cuda_device, monkeypatch, arch, kv_dtype):
    """The rows and the page the bit-for-bit test leaves out differ only
    by the order in which the page-0 scatter's duplicate indices land:
    with index_put sorting them (`torch.use_deterministic_algorithms`),
    the graphed decode gives the eager step's logits and tokens on every
    row, idle and parked ones included, and both pools with page 0, bit
    for bit (8-bit bit-plane weights)."""
    from repro_torch.models import transformer

    dev = cuda_device
    cfg = get_config(arch, smoke=True)
    monkeypatch.setattr(transformer, "moe_forward",
                        _moe_read(transformer.moe_forward))
    params = quantize_tree(
        init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev),
        PimQuantConfig(8, 1, min_features=8))
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, _, ticks, _ = _graphed_and_eager(
            dev, cfg, params, _graph_prompts(cfg.vocab_size), whole=True,
            kv_dtype=kv_dtype, **GRAPH_CASES[arch])
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])
    assert ticks >= 20


@pytest.mark.gpu
def test_dense_dropless_stack_refused_on_the_card(cuda_device):
    """A dense expert stack under dropless routing would run every expert
    over every row on the card; the MoE refuses it and names the cure."""
    from repro_torch.models import forward

    dev = cuda_device
    cfg = get_config("mellum2-12b-a2.5b", smoke=True)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.zeros((1, 4), dtype=torch.long, device=dev)
    with pytest.raises(ValueError, match="--quantize"):
        forward(params, tokens, cfg)


@pytest.mark.gpu
def test_one_capture_per_signature_and_a_new_one_per_pool(cuda_device):
    """A drain captures its decode once (the telemetry's counters say
    so); a pool tensor replaced mid-drain is run eagerly once and then
    captured anew, never replayed stale. The step signatures logged
    (`trace_count`) are those of the eager step."""
    from repro_torch.obs import ManualClock, ServeTelemetry
    from repro_torch.serve.compiled import trace_count

    dev = cuda_device
    cfg = get_config("qwen2-1.5b", smoke=True)
    params = quantize_tree(
        init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev),
        PimQuantConfig(8, 1, min_features=8))
    prompts = _graph_prompts(cfg.vocab_size, n=12, seed=5)
    tel = ServeTelemetry(clock=ManualClock())
    before = trace_count("decode")
    step, eager, _, decodes = _graphed_and_eager(
        dev, cfg, params, prompts, telemetry=tel, replace_pool_at=12)
    assert _graph_counts(tel) == (2, decodes - 4)
    assert (tel.registry.counter("kernel_launches", {"kind": "decode"}).value
            == decodes)
    assert step.cache_size() == eager.cache_size()
    assert trace_count("decode") - before == 2 * step.cache_size()


@pytest.mark.gpu
def test_replays_count_k3_wide_launches(cuda_device):
    """A decode of 32 slots runs K3 on its wide tile (above 24 rows), from
    the decode graphs: each replay adds the wide launches its capture saw
    to `bitplane_gemv.LAUNCHES_WIDE`, so the graphed drain counts them as
    the eager one does, tick by tick (`_graphed_and_eager`), and they are
    counted at every decode."""
    from repro_torch.kernels import bitplane_gemv
    from repro_torch.obs import ManualClock, ServeTelemetry

    dev = cuda_device
    cfg = get_config("qwen2-1.5b", smoke=True)
    params = quantize_tree(
        init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev),
        PimQuantConfig(8, 1, min_features=8))
    tel = ServeTelemetry(clock=ManualClock())
    before = bitplane_gemv.LAUNCHES_WIDE
    _, _, _, decodes = _graphed_and_eager(
        dev, cfg, params, _graph_prompts(cfg.vocab_size), telemetry=tel,
        n_slots=32, prefill_chunk=8)
    assert bitplane_gemv.wide_tile(32)
    assert _graph_counts(tel) == (1, decodes - 2)
    wide = bitplane_gemv.LAUNCHES_WIDE - before
    assert wide >= 2 * decodes, (wide, decodes)


@pytest.mark.gpu
def test_k1_wrapped_after_capture_sees_every_layer(cuda_device, monkeypatch):
    """A `paged_attention` set on `models.attention` after the capture (as
    a profiler range is) is called once per layer of each replayed
    decode, with the tick's plans."""
    from repro_torch.models import attention
    from repro_torch.obs import ManualClock, ServeTelemetry

    dev = cuda_device
    cfg = get_config("qwen2-1.5b", smoke=True)
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tel = ServeTelemetry(clock=ManualClock())
    cb = ContinuousBatcher(cfg, params, n_slots=3, cache_len=64, paged=True,
                           block_size=4, device=dev, telemetry=tel)
    for uid, (p, _) in enumerate(_graph_prompts(cfg.vocab_size)):
        cb.submit(Request(uid=uid, prompt=p, max_new_tokens=12))
    while _graph_counts(tel)[0] == 0:
        cb.step()
    orig = attention.paged_attention
    calls = []

    def counted(*args, **kw):
        calls.append(kw["plan"])
        return orig(*args, **kw)
    monkeypatch.setattr(attention, "paged_attention", counted)
    for _ in range(4):
        replays = _graph_counts(tel)[1]
        n = len(calls)
        cb.step()
        assert _graph_counts(tel)[1] == replays + 1
        assert len(calls) - n == cfg.n_layers
    assert any(plan is not None for plan in calls)


# ---------------------------------------------------------------------------
# K6: the grouped bit-plane GEMV of dropless expert stacks
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("pairs", [1024, 11080])
@pytest.mark.parametrize("k,m", [(2304, 896), (896, 2304)])
def test_k6_equals_k3_row_for_row(cuda_device, k, m, pairs):
    """At mellum2-12b-a2.5b's expert shapes ([2304 -> 896] gate / up,
    [896 -> 2304] down; 8-bit g = 1 planes of all 64 experts) and at a
    decode tick's 128 x 8 pairs and a 1385-token prompt's x 8, one K6
    launch gives each expert's rows exactly what K3 gives them on that
    expert's planes, with the routing's ragged counts (an empty expert
    among them); and `ops.bitplane_grouped_matmul` each row its own
    expert's `bitplane_matmul`, to within bf16 rounding (the row sums of
    x that the offset takes are reduced over another number of rows)."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(k + pairs)
    e = 64
    planes = torch.randint(0, 256, (e, 8, k // 8, m), generator=gen,
                           device=dev, dtype=torch.uint8)
    scale = torch.rand((e, m), generator=gen, device=dev) * 1e-2
    expert = torch.randint(0, e - 1, (pairs,), generator=gen, device=dev)
    expert = torch.sort(expert).values            # expert e - 1 gets none
    counts = torch.bincount(expert, minlength=e)
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()
    x = torch.randn((pairs, k), generator=gen, device=dev).bfloat16()
    x_r = ref.prepare_x_ref(x, 1).contiguous()
    n = bitplane_grouped.LAUNCHES
    raw = bitplane_grouped.bitplane_grouped(x_r, planes, offsets, n_bits=8)
    y = ops.bitplane_grouped_matmul(x, planes, scale, offsets, expert,
                                    n_bits=8)
    assert bitplane_grouped.LAUNCHES == n + 2
    offs = offsets.tolist()
    for i in range(e):
        a, b = offs[i], offs[i + 1]
        if a == b:
            continue
        want = bitplane_gemv.bitplane_gemv(
            ref.prepare_x_ref(x[a:b], 1).contiguous(), planes[i], n_bits=8)
        assert torch.equal(raw[a:b], want), i
        torch.testing.assert_close(y[a:b], ops.bitplane_matmul(
            x[a:b], planes[i], scale[i], n_bits=8))
    plain = bitplane_grouped.bitplane_grouped_ref(x_r, planes, offsets)
    torch.testing.assert_close(raw, plain, rtol=1e-5,
                               atol=1e-5 * float(plain.abs().max()))

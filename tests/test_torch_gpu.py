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
without telemetry.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
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
from repro_torch.serve import ContinuousBatcher, Request


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
])
def test_decode_kernel_ragged_shapes(cuda_device, H, KV, hd, bs, kind):
    """Head groups of 1 to 16, head widths below and between the
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

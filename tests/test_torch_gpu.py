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
in f32, only the summation order differs).
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

"""The benchmark's frozen work counts equal the program's
(`repro_torch/kernels/work.py`) at a few shapes, as they stood when the
benchmark was defined."""

import pytest
import torch

from bench import work
from repro_torch.kernels import work as program_work


@pytest.mark.parametrize("b,h,kv,hd,bs,mb,lengths,window", [
    (4, 40, 8, 128, 16, 260, [1, 1030, 4097, 77], 4160),
    (8, 48, 1, 128, 16, 33, [200, 1, 512, 333, 17, 1, 64, 528], 528),
    (3, 32, 16, 128, 16, 64, [900, 1024, 3], 256),
])
def test_k1_matches_program(b, h, kv, hd, bs, mb, lengths, window):
    q = torch.zeros(b, h, hd, dtype=torch.bfloat16)
    pages = torch.zeros(2, bs, kv, hd, dtype=torch.bfloat16)
    table = torch.zeros(b, mb, dtype=torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32)
    start = torch.zeros(b, dtype=torch.int32)
    want = program_work.decode_work(q, pages, table, lens, window,
                                    block_start=start)
    got = work.k1_work(lengths, n_heads=h, head_dim=hd, n_kv=kv,
                       window=window, block_size=bs, table_width=mb)
    assert got == want


@pytest.mark.parametrize("t,h,kv,hd,bs,mb,spans,window", [
    (2048, 40, 8, 128, 16, 260, [(0, 2040)], 4160),
    (256, 48, 1, 128, 16, 33, [(0, 250)], 528),
    (512, 32, 16, 128, 16, 128, [(1024, 1536), (0, 300)], 1024),
])
def test_k2_matches_program(t, h, kv, hd, bs, mb, spans, window):
    b = len(spans)
    q = torch.zeros(b, t, h, hd, dtype=torch.bfloat16)
    pages = torch.zeros(2, bs, kv, hd, dtype=torch.bfloat16)
    table = torch.zeros(b, mb, dtype=torch.int32)
    start = torch.tensor([s for s, _ in spans], dtype=torch.int32)
    total = torch.tensor([e for _, e in spans], dtype=torch.int32)
    want = program_work.prefill_work(q, pages, table, start, total, window,
                                     block_start=torch.zeros_like(start))
    got = work.k2_work(spans, q_rows=t, n_heads=h, head_dim=hd, n_kv=kv,
                       window=window, block_size=bs, table_width=mb)
    assert got == want


@pytest.mark.parametrize("rows,k,m", [(128, 6144, 24576), (1, 24576, 6144),
                                      (256, 6144, 128), (768, 1536, 8960)])
def test_bitplane_matches_program(rows, k, m):
    x = torch.zeros(rows, k, dtype=torch.bfloat16)
    planes = torch.zeros(8, k // 8, m, dtype=torch.uint8)
    scale = torch.zeros(m, dtype=torch.float32)
    assert work.bitplane_work(rows, k, m) == program_work.bitplane_work(
        x, planes, scale)


def test_model_flops_are_twice_the_matmul_parameters():
    from repro_torch.configs import get_config
    for arch, mlp in (("qwen2.5-14b", "swiglu"), ("granite-20b", "plain")):
        cfg = get_config(arch)
        model = {k: getattr(cfg, k) for k in (
            "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
            "vocab_size", "head_dim", "mlp_kind")}
        from repro_torch.models.transformer import layer_shapes
        shapes = layer_shapes(cfg, torch.bfloat16)
        n = sum(s[0][0] * s[0][1] for grp in ("attn", "mlp")
                for name, s in shapes[grp].items() if name.startswith("w"))
        assert work.token_flops(model) == 2.0 * cfg.n_layers * n
        assert model["mlp_kind"] == mlp
    assert work.bound_s((989e12, 0.0)) == pytest.approx(1.0)
    assert work.bound_s((0.0, 3.35e12)) == pytest.approx(1.0)

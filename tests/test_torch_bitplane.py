"""Bit-plane kernels of the PyTorch port (K3 GEMV, K4 GEMM, K5 pack) and
their ops against the JAX reference, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages.
On CPU tensors the port's kernel wrappers run their plain versions; the
reference's Pallas kernels run in interpret mode, with the block sizes
of `tests/test_kernels.py`. The format matrix is that file's: n_bits
{2, 3, 4, 8} x group {1, 2, 4}, x in f32 and bf16.

Tolerances and why:
  * `quantize_ref` / `pack_ref` / K5: planes and scales EXACTLY equal,
    for f32 and bf16 weights (the dtype rules are mirrored, round is
    half-to-even in both);
  * raw contraction (K3/K4 plain) vs the interpret-mode kernels:
    1e-5 * max|raw| — products of x with integer digits are exact, the
    sums run in another order;
  * `bitplane_matmul(impl="ref")` vs the reference's: 1e-5 relative in
    f32, 2e-2 in bf16 (one bf16 rounding of the output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.bitplane_gemm import bitplane_gemm as j_gemm
from repro.kernels.bitplane_gemv import bitplane_gemv as j_gemv
from repro.kernels.pack import pack_bitplanes as j_pack
from repro_torch.kernels import bitplane_gemm, bitplane_gemv, ops, pack, ref
from repro_torch.quant import PimQuantConfig, PimWeight

FORMATS = [(n, g) for n in (2, 3, 4, 8) for g in (1, 2, 4)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _weights(seed, k, m, dtype="f32"):
    w = np.random.default_rng(seed).normal(size=(k, m)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(w).to(tdt), jnp.asarray(w, jdt)


def _x(seed, b, k, dtype):
    x = np.random.default_rng(seed).normal(size=(b, k)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_bits,group", FORMATS)
def test_quantize_and_pack_bit_exact(dtype, n_bits, group):
    tw, jw = _weights(0, 64, 48, dtype)
    tq, ts = ref.quantize_ref(tw, n_bits)
    jq, js = j_ref.quantize_ref(jw, n_bits)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tp = ref.pack_ref(tq, n_bits, group)
    jp = j_ref.pack_ref(jq, n_bits, group)
    assert tp.dtype == torch.uint8
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ref.unpack_ref(tp, n_bits, group).numpy(),
                                  np.asarray(j_ref.unpack_ref(jp, n_bits,
                                                              group)))
    # the ops entry point, both impls the CPU has, gives the same bytes
    planes, scale = ops.quantize_and_pack(tw, n_bits, group, "ref")
    assert torch.equal(planes, tp) and torch.equal(scale, ts)


@pytest.mark.parametrize("n_bits,group", FORMATS)
def test_pack_plain_matches_jax_pack_kernel(n_bits, group):
    k, m = 64, 128
    tw, jw = _weights(1, k, m)
    jq, _ = j_ref.quantize_ref(jw, n_bits)
    dpb = 8 // group
    ju = (jq + 2 ** (n_bits - 1)).astype(jnp.uint8)
    ju_r = ju.reshape(k // dpb, dpb, m).transpose(1, 0, 2)
    want = j_pack(ju_r, n_bits=n_bits, group=group, block_k8=8, block_m=64,
                  interpret=True)
    u_r = torch.from_numpy(np.array(ju_r))
    before = pack.LAUNCHES
    got = pack.pack_bitplanes(u_r, n_bits, group)
    assert pack.LAUNCHES == before            # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), ref.pack_ref(ref.quantize_ref(tw, n_bits)[0], n_bits,
                                  group).numpy())


GEMV_FORMATS = [(8, 1), (4, 1), (4, 2), (8, 2), (8, 4), (3, 1)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_bits,group", GEMV_FORMATS)
@pytest.mark.parametrize("B,K,M", [(2, 64, 128), (8, 128, 64)])
def test_raw_contraction_matches_jax_gemv(dtype, n_bits, group, B, K, M):
    tw, _ = _weights(2, K, M)
    planes, _ = ops.quantize_and_pack(tw, n_bits, group, "ref")
    tx, jx = _x(3, B, K, dtype)
    want = j_gemv(j_ref.prepare_x_ref(jx, group), jnp.asarray(planes.numpy()),
                  n_bits=n_bits, group=group, block_m=64, block_k8=4,
                  interpret=True)
    x_r = ref.prepare_x_ref(tx, group).contiguous()
    got = bitplane_gemv.bitplane_gemv(x_r, planes, n_bits=n_bits,
                                      group=group)
    assert got.dtype == torch.float32 and got.shape == (B, M)
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_bits,group", [(8, 1), (4, 2), (8, 4), (3, 1)])
def test_raw_contraction_matches_jax_gemm(dtype, n_bits, group):
    B, K, M = 16, 128, 128
    tw, _ = _weights(4, K, M)
    planes, _ = ops.quantize_and_pack(tw, n_bits, group, "ref")
    tx, jx = _x(5, B, K, dtype)
    want = np.asarray(j_gemm(
        j_ref.prepare_x_ref(jx, group), jnp.asarray(planes.numpy()),
        n_bits=n_bits, group=group, block_b=8, block_m=64, block_k8=8,
        interpret=True))
    x_r = ref.prepare_x_ref(tx, group).contiguous()
    got = bitplane_gemm.bitplane_gemm(x_r, planes, n_bits=n_bits,
                                      group=group)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_bits,group", FORMATS)
def test_bitplane_matmul_ref_matches_reference(dtype, n_bits, group):
    tw, _ = _weights(6, 64, 40)
    planes, scale = ops.quantize_and_pack(tw, n_bits, group, "ref")
    tx, jx = _x(7, 3, 64, dtype)
    tx = tx.reshape(3, 1, 64)                 # batch dims are flattened
    want = _jnp(j_ops.bitplane_matmul(
        jx.reshape(3, 1, 64), jnp.asarray(planes.numpy()),
        jnp.asarray(scale.numpy()), n_bits=n_bits, group=group, impl="ref"))
    got = ops.bitplane_matmul(tx, planes, scale, n_bits=n_bits, group=group,
                              impl="ref")
    assert got.dtype == tx.dtype and got.shape == (3, 1, 40)
    tol = 1e-5 if dtype == "f32" else 2e-2
    err = np.abs(_np(got) - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("b,kernel", [(1, "gemv"), (512, "gemv"),
                                      (513, "gemm"), (768, "gemm")])
def test_kernel_path_splits_at_512_rows_and_matches_pallas(monkeypatch, b,
                                                           kernel):
    """The kernel path of `bitplane_matmul` (the raw contraction, then the
    offset and the scale): K3 up to `_GEMV_MAX_B` = 512 rows, K4 above.
    Driven on the CPU by letting the impl resolve to the kernel, whose
    wrappers then run their plain versions; held against the reference's
    Pallas path in interpret mode — except at B = 513, which its GEMM
    refuses (B must divide into blocks of 256 rows), so there against
    its oracle."""
    assert ops._GEMV_MAX_B == 512
    calls = []
    for name, fn in (("gemv", ops.bitplane_gemv), ("gemm", ops.bitplane_gemm)):
        monkeypatch.setattr(
            ops, f"bitplane_{name}",
            lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw))
    monkeypatch.setattr(ops, "resolve_impl", lambda impl, device: "cuda")
    tw, _ = _weights(8, 64, 64)
    planes, scale = ops.quantize_and_pack(tw, 8, 1, "ref")
    tx, jx = _x(9, b, 64, "f32")
    got = ops.bitplane_matmul(tx, planes, scale, n_bits=8, group=1)
    assert calls == [kernel]
    j_impl = "ref" if b == 513 else "pallas_interpret"
    want = _jnp(j_ops.bitplane_matmul(
        jx, jnp.asarray(planes.numpy()), jnp.asarray(scale.numpy()), n_bits=8,
        group=1, impl=j_impl, block_m=64, block_k8=8))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("k8,m,group", [
    (192, 256, 1), (192, 1536, 1), (192, 8960, 1), (1120, 1536, 1),
    (25, 101, 1), (50, 101, 2), (100, 101, 4), (384, 256, 2), (0, 64, 1),
])
def test_gemm_splits_cover_k_in_whole_nonempty_ranges(k8, m, group):
    """K4's K split: a function of the weight alone, each range whole
    pairs of chunks and none empty, and never more blocks than
    `MAX_TILES` column tiles x splits."""
    n_pairs = -(-k8 // (bitplane_gemm.PAIR_K * group // 8))
    s = bitplane_gemm.gemm_splits(k8, m, group)
    assert s >= 1
    per = -(-n_pairs // s)
    assert s == 1 or (s - 1) * per < n_pairs <= s * per
    assert s == 1 or -(-m // bitplane_gemm.TILE_M) * s <= \
        bitplane_gemm.MAX_TILES


def test_gemm_splits_fill_the_card_on_the_main_path():
    """At a 768-row prefill every qwen2-1.5b projection launches at
    least 132 blocks (one per H100 SM), the long-K and narrow ones by
    splitting K."""
    row_tiles = -(-768 // 128)
    for k, m in ((1536, 256), (1536, 1536), (1536, 8960), (8960, 1536)):
        s = bitplane_gemm.gemm_splits(k // 8, m, 1)
        col_tiles = -(-m // bitplane_gemm.TILE_M)
        assert row_tiles * col_tiles * s >= 132, (k, m, s)


@pytest.mark.parametrize("k8,m,group", [
    (192, 256, 1), (192, 1536, 1), (192, 8960, 1), (1120, 1536, 1),
    (384, 256, 2), (768, 8960, 4), (25, 101, 1), (50, 101, 2),
    (100, 101, 4), (1, 8, 1), (0, 64, 1),
])
def test_gemv_splits_cover_k_in_whole_nonempty_ranges(k8, m, group):
    """K3's K split: a function of (K8, M, g) alone — the same answer
    however often it is asked, and no B in its signature — each range
    whole chunks and none empty, never more ranges than chunks."""
    n_chunks = -(-k8 // (bitplane_gemv.CHUNK_K * group // 8))
    s = bitplane_gemv.gemv_splits(k8, m, group)
    assert s == bitplane_gemv.gemv_splits(k8, m, group)
    assert s >= 1
    per = -(-n_chunks // s)
    assert s == 1 or (s - 1) * per < n_chunks <= s * per
    assert s <= max(n_chunks, 1)


@pytest.mark.parametrize("k,m", [(1536, 256), (1536, 1536), (1536, 8960),
                                 (8960, 1536)])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_gemv_splits_fill_the_card_on_the_main_path(k, m, group):
    """At a decode tick's 8 rows (one row tile) every qwen2-1.5b
    projection launches at least 132 blocks, one per H100 SM."""
    s = bitplane_gemv.gemv_splits(k * group // 8, m, group)
    assert -(-m // bitplane_gemv.TILE_M) * s >= 132, (k, m, group, s)


@pytest.mark.parametrize("b,wide", [(1, False), (16, False), (24, False),
                                    (25, True), (64, True), (65, True),
                                    (128, True), (512, True)])
def test_wide_tile_is_a_function_of_rows(b, wide):
    """K3's tile rule: the narrow tile up to `NARROW_MAX_B` = 24 rows,
    the wide one above, whatever the weight."""
    assert bitplane_gemv.NARROW_MAX_B == 24
    assert bitplane_gemv.wide_tile(b) is wide


@pytest.mark.parametrize("k,m,splits", [
    (6144, 6144, 3), (6144, 128, 96), (6144, 24576, 1), (24576, 6144, 3),
    (2304, 4096, 5), (2304, 512, 18), (4096, 2304, 8),
])
def test_gemv_splits_on_the_cells_shapes(k, m, splits):
    """K3's K ranges on granite-20b's projections (q / o, k / v, up,
    down) and mellum2-12b-a2.5b's attention (q, k / v, o) at 8-bit g = 1:
    pinned, so the wide tile walks the ranges the narrow tile walked."""
    assert bitplane_gemv.gemv_splits(k // 8, m, 1) == splits


@pytest.mark.parametrize("dtype,b,k8,group,want", [
    (torch.bfloat16, 128, 768, 1, 96 * 128 * 64),
    (torch.bfloat16, 129, 768, 1, 96 * 256 * 64),
    (torch.float32, 187, 25, 2, 3 * 2 * 256 * 64),
])
def test_wide_x_elements(dtype, b, k8, group, want):
    """The wide tile's x scratch: each bf16 term (3 for f32) of every
    chunk of 64 k for the rows rounded up to 128."""
    assert bitplane_gemv.wide_x_elements(dtype, b, k8, group) == want


def test_cuda_impl_raises_on_cpu_tensors():
    tw, _ = _weights(10, 64, 32)
    planes, scale = ops.quantize_and_pack(tw, 8, 1, "ref")
    x = torch.zeros((2, 64))
    with pytest.raises(RuntimeError, match="impl='cuda'"):
        ops.bitplane_matmul(x, planes, scale, n_bits=8, impl="cuda")
    with pytest.raises(RuntimeError, match="impl='cuda'"):
        ops.quantize_and_pack(tw, 8, 1, "cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.bitplane_matmul(x, planes, scale, n_bits=8, impl="pallas")


def test_wrappers_reject_what_the_kernels_do_not_take():
    planes = torch.zeros((8, 8, 32), dtype=torch.uint8)
    x_r = torch.zeros((8, 2, 8))
    with pytest.raises(ValueError, match="n_bits"):
        bitplane_gemv.bitplane_gemv(x_r, planes, n_bits=9)
    with pytest.raises(ValueError, match="group"):
        bitplane_gemm.bitplane_gemm(x_r, planes, n_bits=8, group=3)
    with pytest.raises(ValueError, match="planes must be"):
        bitplane_gemv.bitplane_gemv(x_r, planes[:4], n_bits=8)
    with pytest.raises(ValueError, match="uint8"):
        bitplane_gemv.bitplane_gemv(x_r, planes.int(), n_bits=8)
    with pytest.raises(ValueError, match="x_r dtype"):
        bitplane_gemm.bitplane_gemm(x_r.half(), planes, n_bits=8)
    with pytest.raises(ValueError, match="x_r must be"):
        bitplane_gemv.bitplane_gemv(x_r[:4], planes, n_bits=8)
    with pytest.raises(ValueError, match="u_r"):
        pack.pack_bitplanes(torch.zeros((4, 8, 32), dtype=torch.uint8), 8, 1)
    with pytest.raises(ValueError, match="uint8"):
        pack.pack_bitplanes(torch.zeros((8, 8, 32)), 8, 1)


@pytest.mark.parametrize("k,m,n_bits,group", [
    (4096, 4096, 8, 1), (4096, 4096, 4, 1), (1536, 256, 8, 1),
    (8960, 1536, 3, 1), (64, 48, 4, 2), (200, 101, 8, 4)])
def test_packed_bytes_equal_reference(k, m, n_bits, group):
    assert ops.packed_bytes(k, m, n_bits, group) == j_ops.packed_bytes(
        k, m, n_bits, group)


def test_pim_weight_stack_view_and_bytes():
    """A stacked [L, K, M] weight quantizes slice by slice; `w[l]` is
    layer l's planes and scale, and the bytes count every slice."""
    w = torch.from_numpy(np.random.default_rng(11).normal(
        size=(3, 64, 40)).astype(np.float32))
    cfg = PimQuantConfig(n_bits=4, group=2, min_features=1)
    pw = PimWeight.from_dense(w, cfg)
    assert pw.planes.shape == (3, 2, 16, 40) and pw.scale.shape == (3, 40)
    assert pw.shape == (64, 40) and pw.n_stack == 3
    assert pw.packed_bytes == 3 * ops.packed_bytes(64, 40, 4, 2)
    for l in range(3):
        planes, scale = ops.quantize_and_pack(w[l], 4, 2, "ref")
        assert torch.equal(pw[l].planes, planes)
        assert torch.equal(pw[l].scale, scale)
    deq = pw[1].dequantize()
    assert torch.all((deq - w[1]).abs() <= pw[1].scale / 2 + 1e-6)

"""Paged-attention kernels K1 (decode) and K2 (prefill) of the PyTorch
port, plain versions, against the JAX reference: the Pallas kernels in
interpret mode and the jnp oracles, on the shape matrix of
tests/test_paged_kernels.py — ragged lengths including 0 and 1, windows
64/5/3/1, single-block, full-pool and COW-fragmented tables, prefix
offsets, bf16 and int8 pools.

Tolerance: f32, atol = rtol = 1e-5, on valid rows only (decode: length
>= 1; prefill: query position < total). Other rows are don't-care in
both packages, and the CUDA kernels skip wholly masked pages, so their
garbage differs by design. Both sides fold the same pages in f32; the
difference is summation order and where hd^-0.5 is applied.

The CUDA kernels themselves run only on the card: `chip_smoke.py`
holds them against these plain versions there, and so do the
`gpu`-marked tests of tests/test_torch_gpu.py under pytest.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_decode_attention as j_decode
from repro.kernels.paged_common import quantize_pages as j_quantize
from repro.kernels.paged_prefill import paged_prefill_attention as j_prefill
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as k1
from repro_torch.kernels.paged_attention import (
    decode_ranges,
    paged_attention,
    paged_decode_attention,
    paged_decode_attention_bucketed,
)
from repro_torch.kernels.paged_common import (
    bucketed_page_dispatch,
    check_quantized_operands,
    dequantize_pages,
    quantize_pages,
)
from repro_torch.kernels.paged_prefill import (
    CHUNK_KEYS,
    MAX_RANGES,
    RANGE_CHUNKS,
    paged_prefill,
    paged_prefill_attention,
    paged_prefill_attention_bucketed,
    walk_ranges,
)

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a, dtype=None):
    """numpy (or a JAX array via numpy) -> torch CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _pools(rng, nb, bs, kv, hd):
    return (rng.normal(size=(nb, bs, kv, hd)).astype(np.float32),
            rng.normal(size=(nb, bs, kv, hd)).astype(np.float32))


def _pool_pair(kp, vp, kind):
    """(jax operands, torch operands) of one pool kind: k, v, ks, vs."""
    if kind == "f32":
        j = (jnp.asarray(kp), jnp.asarray(vp), None, None)
    elif kind == "bf16":
        j = (jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16),
             None, None)
    else:
        kq, ks = j_quantize(jnp.asarray(kp))
        vq, vs = j_quantize(jnp.asarray(vp))
        j = (kq, vq, ks, vs)
    return j, tuple(None if x is None else _t(x) for x in j)


def _check_decode(q, kp, vp, bt, lengths, window, kind="f32"):
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _pool_pair(kp, vp, kind)
    jq, jbt = jnp.asarray(q), jnp.asarray(bt)
    jl, jw = jnp.asarray(lengths, jnp.int32), jnp.asarray(window, jnp.int32)
    interp = np.asarray(j_decode(jq, jk, jv, jbt, jl, jw, k_scales=jks,
                                 v_scales=jvs, interpret=True))
    oracle = np.asarray(jref.paged_attention_ref(
        jq, jk, jv, jbt, jl, jw, k_scales=jks, v_scales=jvs))
    tq, tbt = _t(q), _t(bt)
    tl = torch.tensor(lengths, dtype=torch.int32)
    ours = {
        "plain": paged_attention(tq, tk, tv, tbt, tl, window, impl="ref",
                                 k_scales=tks, v_scales=tvs),
        "wrapper": paged_decode_attention(tq, tk, tv, tbt, tl, window,
                                          k_scales=tks, v_scales=tvs),
    }
    valid = np.asarray(lengths) > 0
    for name, out in ours.items():
        out = out.numpy()
        assert out.shape == interp.shape and out.dtype == np.float32, name
        np.testing.assert_allclose(out[valid], interp[valid], **TOL)
        np.testing.assert_allclose(out[valid], oracle[valid], **TOL)
    # the plain version keeps the reference oracle's don't-care rows too
    np.testing.assert_allclose(ours["plain"].numpy(), oracle, **TOL)
    _check_decode_bucketed(tq, tk, tv, tbt, tl, window, tks, tvs, valid)


def _check_decode_bucketed(tq, tk, tv, tbt, tl, window, tks, tvs, valid):
    """The bucket scaffold around the plain version equals the single
    launch on valid rows: exactly around the full-table walk, and to f32
    rounding around the depth-bounded walk (a shorter gather sums its
    exact zeros in another order)."""
    plan, perm = ops.make_bucket_plan(tl.numpy(), tk.shape[1], tbt.shape[1])
    if plan is None:
        return
    perm = torch.tensor(perm, dtype=torch.int64)
    single = paged_decode_attention(tq, tk, tv, tbt, tl, window,
                                    k_scales=tks, v_scales=tvs)

    def full_walk(depth, bt_rows, q_rows, len_rows):
        return ref.paged_attention_ref(q_rows, tk, tv, bt_rows, len_rows,
                                       window, k_scales=tks, v_scales=tvs)

    scaffold = bucketed_page_dispatch(full_walk, plan, perm, tbt, [tq, tl])
    np.testing.assert_array_equal(scaffold.numpy()[valid],
                                  single.numpy()[valid])
    bucketed = paged_decode_attention_bucketed(
        tq, tk, tv, tbt, tl, window, plan, perm, k_scales=tks, v_scales=tvs)
    np.testing.assert_allclose(bucketed.numpy()[valid],
                               single.numpy()[valid], rtol=1e-6, atol=1e-6)


def _check_prefill(q, kp, vp, bt, start, total, window, kind="f32"):
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _pool_pair(kp, vp, kind)
    jq, jbt = jnp.asarray(q), jnp.asarray(bt)
    js, jt = jnp.asarray(start, jnp.int32), jnp.asarray(total, jnp.int32)
    jw = jnp.asarray(window, jnp.int32)
    interp = np.asarray(j_prefill(jq, jk, jv, jbt, js, jt, jw, k_scales=jks,
                                  v_scales=jvs, interpret=True))
    oracle = np.asarray(jref.paged_prefill_ref(
        jq, jk, jv, jbt, js, jt, jw, k_scales=jks, v_scales=jvs))
    tq, tbt = _t(q), _t(bt)
    ts = torch.tensor(start, dtype=torch.int32)
    tt = torch.tensor(total, dtype=torch.int32)
    ours = {
        "plain": paged_prefill(tq, tk, tv, tbt, ts, tt, window, impl="ref",
                               k_scales=tks, v_scales=tvs),
        "wrapper": paged_prefill_attention(tq, tk, tv, tbt, ts, tt, window,
                                           k_scales=tks, v_scales=tvs),
    }
    t = q.shape[1]
    valid = (np.asarray(start)[:, None] + np.arange(t)[None, :]
             < np.asarray(total)[:, None])                    # [B, T]
    for name, out in ours.items():
        out = out.numpy()
        assert out.shape == interp.shape and out.dtype == np.float32, name
        np.testing.assert_allclose(out[valid], interp[valid], **TOL)
        np.testing.assert_allclose(out[valid], oracle[valid], **TOL)
    np.testing.assert_allclose(ours["plain"].numpy(), oracle, **TOL)
    plan, perm = ops.make_bucket_plan(np.asarray(total), tk.shape[1],
                                      tbt.shape[1])
    if plan is not None:
        bucketed = paged_prefill_attention_bucketed(
            tq, tk, tv, tbt, ts, tt, window, plan,
            torch.tensor(perm, dtype=torch.int64), k_scales=tks, v_scales=tvs)
        np.testing.assert_allclose(bucketed.numpy()[valid],
                                   ours["wrapper"].numpy()[valid],
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# decode matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [64, 5, 3, 1])
@pytest.mark.parametrize("lengths", [[5, 12, 1], [0, 12, 4], [0, 0, 1]])
def test_decode_ragged_lengths_and_windows(rng, window, lengths):
    B, H, KV, hd, bs, nb, mb = 3, 4, 2, 8, 4, 10, 3
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp, vp = _pools(rng, nb, bs, KV, hd)
    bt = rng.permutation(np.arange(1, nb))[: B * mb].reshape(B, mb)
    _check_decode(q, kp, vp, bt.astype(np.int32), lengths, window)


def test_decode_single_block_table(rng):
    B, H, KV, hd, bs, nb = 2, 4, 2, 8, 4, 5
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp, vp = _pools(rng, nb, bs, KV, hd)
    _check_decode(q, kp, vp, np.array([[3], [1]], np.int32), [4, 2], 16)


def test_decode_full_pool_table(rng):
    B, H, KV, hd, bs, nb = 2, 4, 2, 8, 4, 9
    mb = (nb - 1) // B
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp, vp = _pools(rng, nb, bs, KV, hd)
    bt = rng.permutation(np.arange(1, nb)).reshape(B, mb).astype(np.int32)
    _check_decode(q, kp, vp, bt, [mb * bs, mb * bs - 3], mb * bs)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_decode_cow_fragmented_tables(rng, kind):
    B, H, KV, hd, bs, nb = 3, 4, 2, 8, 4, 12
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp, vp = _pools(rng, nb, bs, KV, hd)
    bt = np.array([[7, 2, 11, 3], [2, 7, 2, 5], [10, 1, 4, 9]], np.int32)
    _check_decode(q, kp, vp, bt, [13, 16, 9], 6, kind)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("lengths", [[5, 12, 1], [0, 12, 4]])
def test_decode_low_precision_pools(rng, kind, lengths):
    B, H, KV, hd, bs, nb, mb = 3, 4, 2, 8, 4, 10, 3
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp, vp = _pools(rng, nb, bs, KV, hd)
    bt = rng.permutation(np.arange(1, nb))[: B * mb].reshape(B, mb)
    _check_decode(q, kp, vp, bt.astype(np.int32), lengths, 64, kind)


def test_decode_bucketed_many_slots(rng):
    """Enough ragged slots that the plan has several buckets with count
    padding (dummy rows)."""
    B, H, KV, hd, bs, nb, mb = 6, 4, 2, 8, 4, 40, 6
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kp, vp = _pools(rng, nb, bs, KV, hd)
    bt = rng.permutation(np.arange(1, nb))[: B * mb].reshape(B, mb)
    _check_decode(q, kp, vp, bt.astype(np.int32), [1, 3, 17, 4, 0, 24], 64,
                  "int8")


# ---------------------------------------------------------------------------
# prefill matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [64, 5])
@pytest.mark.parametrize("start,total", [
    ([0, 0, 0], [6, 11, 4]),     # prefix miss: full causal prefill
    ([4, 8, 4], [11, 9, 12]),    # prefix hits: offset causal mask
    ([8, 0, 11], [9, 1, 12]),    # full-hit 1-token recompute + tiny
])
def test_prefill_offsets_ragged_windows(rng, window, start, total):
    B, T, H, KV, hd, bs, nb, mb = 3, 8, 4, 2, 8, 4, 10, 3
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    kp, vp = _pools(rng, nb, bs, KV, hd)
    bt = rng.permutation(np.arange(1, nb))[: B * mb].reshape(B, mb)
    _check_prefill(q, kp, vp, bt.astype(np.int32), start, total, window)


def test_prefill_single_block_table(rng):
    B, T, H, KV, hd, bs, nb = 2, 4, 4, 2, 8, 4, 5
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    kp, vp = _pools(rng, nb, bs, KV, hd)
    _check_prefill(q, kp, vp, np.array([[2], [4]], np.int32), [0, 0],
                   [4, 3], 16)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_prefill_cow_fragmented_tables(rng, kind):
    B, T, H, KV, hd, bs, nb = 3, 8, 4, 2, 8, 4, 12
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    kp, vp = _pools(rng, nb, bs, KV, hd)
    bt = np.array([[5, 9, 1, 3], [5, 9, 2, 7], [5, 5, 10, 4]], np.int32)
    _check_prefill(q, kp, vp, bt, [8, 8, 4], [14, 16, 10], 7, kind)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_prefill_low_precision_pools(rng, kind):
    B, T, H, KV, hd, bs, nb, mb = 3, 8, 4, 2, 8, 4, 10, 3
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    kp, vp = _pools(rng, nb, bs, KV, hd)
    bt = rng.permutation(np.arange(1, nb))[: B * mb].reshape(B, mb)
    _check_prefill(q, kp, vp, bt.astype(np.int32), [4, 8, 4], [11, 9, 12],
                   64, kind)


# ---------------------------------------------------------------------------
# int8 page codec
# ---------------------------------------------------------------------------

def test_quantize_pages_bitwise_equal_to_reference(rng):
    pages = rng.normal(size=(5, 4, 2, 8)).astype(np.float32)
    pages[1] = 0.0                              # all-zero planes: scale 1.0
    # absmax 127 -> scale 1.0: exact .5 codes exercise round-half-even
    pages[2, :, 0, :] = np.linspace(-126.5, 127.0, 32).reshape(4, 8)
    pages[2, 0, 1, :] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 127.0]
    jc, js = j_quantize(jnp.asarray(pages))
    tc, ts = quantize_pages(torch.from_numpy(pages))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequantize_pages(tc, ts).numpy(),
        np.asarray(jc).astype(np.float32) * np.asarray(js)[..., None, :, None],
    )
    assert tc.numpy()[2, 0, 1].tolist() == [0, 2, 2, 0, -2, -2, 4, 127]


# ---------------------------------------------------------------------------
# dispatch rules and module hygiene
# ---------------------------------------------------------------------------

def test_cuda_impl_on_cpu_tensors_raises_and_unknown_impl_raises(rng):
    q = torch.zeros((1, 2, 8))
    kp = torch.zeros((3, 4, 1, 8))
    bt = torch.ones((1, 2), dtype=torch.int32)
    ln = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="impl='cuda'"):
        paged_attention(q, kp, kp, bt, ln, 8, impl="cuda")
    with pytest.raises(RuntimeError, match="impl='cuda'"):
        paged_prefill(q[:, None], kp, kp, bt, ln - 1, ln, 8, impl="cuda")
    for fn, args in ((paged_attention, (q, kp, kp, bt, ln, 8)),
                     (paged_prefill, (q[:, None], kp, kp, bt, ln - 1, ln, 8))):
        with pytest.raises(ValueError, match="unknown impl"):
            fn(*args, impl="pallas")


def test_quantized_operand_pairing_is_enforced():
    codes = torch.zeros((3, 4, 1, 8), dtype=torch.int8)
    scales = torch.ones((3, 1))
    assert check_quantized_operands(codes, scales, scales) is True
    assert check_quantized_operands(codes.float(), None, None) is False
    with pytest.raises(ValueError, match="require k_scales"):
        check_quantized_operands(codes, None, None)
    with pytest.raises(ValueError, match="must not pass"):
        check_quantized_operands(codes.float(), scales, scales)


def test_kernel_modules_import_without_nvcc_or_gpu(tmp_path):
    """Importing every kernel, model and serve module — the launcher
    included — needs neither nvcc nor a card, and builds nothing."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(REPO, "src"))
    code = (
        "import repro_torch.kernels, repro_torch.serve, repro_torch.bridge\n"
        "import repro_torch.launch.serve\n"
        "from repro_torch.kernels import _build, paged_attention, "
        "paged_prefill\n"
        "assert not _build._LIBS\n"
        "assert paged_attention.LAUNCHES == paged_prefill.LAUNCHES == 0\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("mb,bs", [(1, 16), (8, 16), (32, 16), (33, 16),
                                   (68, 16), (128, 16), (2048, 16), (25, 4),
                                   (6, 24), (10, 64)])
def test_prefill_walk_ranges_cover_the_table(mb, bs):
    """K2's split of the page walk: from the table's width and page size
    alone, at most MAX_RANGES ranges that together cover every chunk of
    the widest walk, none of them empty; a single range up to
    RANGE_CHUNKS chunks."""
    n_chunks = mb * -(-bs // CHUNK_KEYS)
    count, chunks = walk_ranges(mb, bs)
    assert 1 <= count <= MAX_RANGES
    assert (count - 1) * chunks < n_chunks <= count * chunks
    assert (count == 1) == (n_chunks <= RANGE_CHUNKS) or count == MAX_RANGES



@pytest.mark.parametrize("mb,bs", [(68, 16), (128, 16), (1, 16), (8, 16),
                                   (9, 16), (25, 4), (6, 24), (10, 64),
                                   (2048, 16)])
def test_decode_ranges_cover_the_table_at_fixed_columns(mb, bs):
    """K1's split of the page walk: from the table's width and page size
    alone, ranges of RANGE_CHUNKS chunks starting at fixed multiples of
    it, which together cover every chunk of the table and none of which
    is empty; at the main path's 68 columns and chip_smoke's 128, enough
    ranges for 8 slots x 2 kv-heads to put a block on each H100 SM."""
    cpp = -(-bs // k1.CHUNK_KEYS)
    n_chunks = mb * cpp
    count, chunks = decode_ranges(mb, bs)
    assert chunks == k1.RANGE_CHUNKS <= 32
    assert (count - 1) * chunks < n_chunks <= count * chunks
    starts = [r * chunks for r in range(count)]
    assert starts[-1] < n_chunks
    if (mb, bs) in ((68, 16), (128, 16)):
        assert 8 * 2 * count >= 132


@pytest.mark.parametrize("window", [68 * 16, 256])
def test_decode_ranges_ignore_depth_and_block_start(monkeypatch, rng,
                                                    window):
    """A bucketed decode makes launches of other depths and block_starts
    than the single launch, yet each gets the table at its full width,
    so `decode_ranges` — a function of (width, page size) only — gives
    every launch the same split at the same table columns."""
    mb, bs, B = 68, 16, 8
    lens = np.array([1, 100, 300, 517, 700, 900, 1000, 1088])
    start = np.maximum(lens - window, 0) // bs
    needs = -(-lens // bs) - start
    plan, perm = ops.make_bucket_plan(lens, bs, mb, needs=needs)
    assert plan is not None and len(plan) > 1
    seen = []
    real = k1.paged_decode_attention

    def spy(q, kp, vp, bt, ln, w, **kw):
        seen.append((bt.shape[1], kw["depth"],
                     tuple(kw["block_start"].tolist())))
        return real(q, kp, vp, bt, ln, w, **kw)

    monkeypatch.setattr(k1, "paged_decode_attention", spy)
    q = torch.zeros((B, 2, 8))
    pools = torch.zeros((B * mb + 1, bs, 1, 8))
    table = torch.arange(1, B * mb + 1, dtype=torch.int32).reshape(B, mb)
    k1.paged_decode_attention_bucketed(
        q, pools, pools, table, torch.tensor(lens, dtype=torch.int32),
        window, plan, torch.tensor(perm),
        block_start=torch.tensor(start, dtype=torch.int32))
    assert len(seen) == len(plan)
    assert len({d for _, d, _ in seen}) == len(plan)
    assert {decode_ranges(width, bs) for width, _, _ in seen} == \
        {decode_ranges(mb, bs)}

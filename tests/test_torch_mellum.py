"""mellum2-12b-a2.5b on the port against its plain reference, on the CPU.

The reference (the benchmark's `bench/models/moe_decoder.py`, plain
PyTorch in f32 that imports nothing of either package: the reference
package has no such model) draws the weights, and
the port serves the same tree at `smoke()`: three windowed layers and
one global, window 8, 8 experts top-4, YaRN over an original 16
positions, dropless routing.

Tolerances. The port in f32 against the f32 reference: logits within
`F32_TOL` of each other, relative to the largest logit. The two sum in
other orders (blocked attention, per-expert against sorted-row products,
the gates added in another order), which moves the last bits only:
measured 6.9e-7 with dense weights and 1.0e-6 with 8-bit planes, so the
tolerance leaves 20x room. The same port in bf16, the precision below,
reads 0.11 (`test_bf16_stand_in_fails_the_f32_tolerance`), so the
tolerance would catch a step computed in a lower precision.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import Yarn
from repro_torch.kernels import bitplane_gemv, bitplane_grouped, ops, ref
from repro_torch.models import decode_step_paged, prefill_paged
from repro_torch.models.common import apply_rope, rope_frequencies
from repro_torch.obs import ManualClock, ServeTelemetry
from repro_torch.quant import PimQuantConfig, quantize_tree
from repro_torch.serve import ContinuousBatcher, PagedKVCache, Request

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mellum2-12b-a2.5b"
#: f32 port against the f32 reference, relative to the largest |logit|
F32_TOL = 2e-5
BS, MAX_LEN = 4, 48


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def plain():
    return _load(ROOT / "bench" / "models" / "moe_decoder.py",
                 "plain_moe_decoder")


def _cfg(dtype="float32", **kw):
    return dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype,
                               **kw)


def _model(cfg):
    return dataclasses.asdict(cfg)


def _serve_logits(cfg, params, prompts, n_new, rng):
    """Paged prefill of each prompt (one slot each), then `n_new` decode
    steps of every slot through the cache with tokens drawn by `rng`:
    each slot's sequence and its logits at every served position."""
    pc = PagedKVCache(cfg, n_slots=len(prompts), max_len=MAX_LEN,
                      block_size=BS, device="cpu")
    seqs, logits = [], []
    for i, p in enumerate(prompts):
        n = len(p)
        pc.alloc_slot(i, n)
        pc.begin_append(i, 0, n)
        toks = np.zeros((1, -(-n // BS) * BS), np.int32)
        toks[0, :n] = p
        bt = pc.device_block_tables()[:, i: i + 1].contiguous()
        st = pc.device_block_starts()[:, i: i + 1].contiguous()
        out = prefill_paged(params, torch.tensor(toks), pc.k_pages,
                            pc.v_pages, bt, torch.tensor([0], dtype=torch.int32),
                            torch.tensor([n], dtype=torch.int32), cfg,
                            last_pos=n - 1, impl="auto", block_start=st)
        pc.lengths[i] = n
        seqs.append(list(p))
        logits.append([out[0][0, -1].float()])
    for _ in range(n_new):
        toks = rng.integers(0, cfg.vocab_size, (len(prompts), 1))
        for i in range(len(prompts)):
            pc.begin_append(i, int(pc.lengths[i]), 1)
        out = decode_step_paged(
            params, torch.tensor(toks.astype(np.int32)), pc.k_pages,
            pc.v_pages, pc.device_block_tables(),
            torch.tensor(np.asarray(pc.lengths, np.int32)), cfg, impl="auto",
            block_start=pc.device_block_starts())
        for i in range(len(prompts)):
            seqs[i].append(int(toks[i, 0]))
            logits[i].append(out[0][i, -1].float())
        pc.lengths += 1
    return seqs, [torch.stack(lg) for lg in logits]


def _reference(plain, cfg, params, seqs, prompts, served=None):
    return plain.reference_logits(
        params, _model(cfg), [torch.tensor(s) for s in seqs],
        [len(p) - 1 for p in prompts], served=served)


def _worst(port, want):
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(port, want))


def _prompts(rng, vocab):
    # past the window (8) and past YaRN's original context (16) in decode
    return [rng.integers(0, vocab, n).astype(np.int32) for n in (19, 6)]


@pytest.mark.parametrize("weights", ["dense", "pim8"])
def test_paged_serving_matches_plain_reference(plain, weights):
    """Paged prefill, then 14 decode steps through the cache (positions
    up to 32: every windowed layer retires pages, the global layer's
    YaRN runs past its original context), against the reference's full
    forward pass at every served position; with 8-bit bit-plane weights
    the reference quantizes as the serving set-up does."""
    cfg = _cfg()
    params = plain.make_params(_model(cfg), 3, "cpu")
    served = None
    if weights == "pim8":
        params = quantize_tree(params, PimQuantConfig(8, 1, min_features=1))
        served = "int8"
    rng = np.random.default_rng(0)
    prompts = _prompts(rng, cfg.vocab_size)
    seqs, port = _serve_logits(cfg, params, prompts, 14, rng)
    want = _reference(plain, cfg, plain.make_params(_model(cfg), 3, "cpu"),
                      seqs, prompts, served)
    assert _worst(port, want) < F32_TOL


def test_bf16_stand_in_fails_the_f32_tolerance(plain):
    """The port with its weights and activations in bf16 against the same
    f32 reference misses `F32_TOL` by far: the tolerance tells the
    configuration's precision from the one below it."""
    cfg = _cfg("bfloat16")
    params = plain.make_params(_model(cfg), 3, "cpu")
    rng = np.random.default_rng(0)
    prompts = _prompts(rng, cfg.vocab_size)
    seqs, port = _serve_logits(cfg, params, prompts, 14, rng)
    ref_params = plain.make_params(_model(cfg), 3, "cpu")
    want = _reference(plain, _cfg(), ref_params, seqs, prompts)
    assert _worst(port, want) > 10 * F32_TOL


def _drain_logits(cfg, params, requests, telemetry=None):
    """A paged drain on 8 slots; per uid, the logits of its prefill's
    last position and of each decode row it took, in order."""
    cb = ContinuousBatcher(cfg, params, n_slots=8, cache_len=MAX_LEN,
                           paged=True, block_size=BS, device="cpu",
                           telemetry=telemetry)
    got = {uid: [] for uid, _, _ in requests}
    decode, prefill = cb._decode_paged, cb._prefill_paged

    def dec(*args, **kw):
        rows = {i: s.uid for i, s in enumerate(cb.slots) if s is not None}
        out = decode(*args, **kw)
        for i, uid in rows.items():
            got[uid].append(out[0][i, -1].clone())
        return out

    def pre(*args, **kw):
        out = prefill(*args, **kw)
        pre.last = out[0][0, -1].clone()
        return out

    seat = cb._start_slot

    def start(i, req, logits):
        got[req.uid].append(pre.last)
        return seat(i, req, logits)

    cb._decode_paged, cb._prefill_paged, cb._start_slot = dec, pre, start
    for uid, p, n in requests:
        cb.submit(Request(uid=uid, prompt=p, max_new_tokens=n))
    cb.run_until_drained()
    return got, cb


@pytest.mark.parametrize("capacity_factor,independent",
                         [(0.0, True), (1.25, False)],
                         ids=["dropless", "capacity"])
def test_a_request_does_not_depend_on_its_batch_mates(plain,
                                                      capacity_factor,
                                                      independent):
    """One request served alone (seven idle slots) and beside seven
    others gives the same logits at every position, bit for bit, with
    dropless routing and 8-bit bit-plane weights at the served dtype.
    The capacity path at the same shapes does not: at 1.25 an expert has
    5 places for the decode's 8 rows x 4 choices over 8 experts, and
    its rows compete for them, idle slots included."""
    cfg = _cfg("bfloat16", capacity_factor=capacity_factor)
    params = quantize_tree(plain.make_params(_model(cfg), 5, "cpu"),
                           PimQuantConfig(8, 1, min_features=1))
    rng = np.random.default_rng(1)
    mine = (0, rng.integers(0, cfg.vocab_size, 13).astype(np.int32), 12)
    mates = [(uid, rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
             for uid, n, m in ((1, 9, 16), (2, 17, 5), (3, 4, 20), (4, 11, 9),
                               (5, 3, 14), (6, 15, 7), (7, 6, 18))]
    alone, _ = _drain_logits(cfg, params, [mine])
    # beside its mates it takes the last slot: last in the routing's
    # priority, where the capacity path drops first
    beside, _ = _drain_logits(cfg, params, mates + [mine])
    same = all(torch.equal(a, b) for a, b in zip(alone[0], beside[0]))
    assert len(alone[0]) == len(beside[0]) == 12
    assert same is independent


def test_moe_counters_count_every_pair():
    """With telemetry, the dropless layers count on the device: pairs =
    top_k x layers x rows routed (every decode row, idle slots included,
    and every padded prefill row), one call per layer and step, and an
    eager call's `model/moe` span inside its step."""
    cfg = _cfg("bfloat16")
    from repro_torch.models import init_lm
    params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    tel = ServeTelemetry(clock=ManualClock())
    rng = np.random.default_rng(2)
    reqs = [(uid, rng.integers(0, cfg.vocab_size, n).astype(np.int32), 6)
            for uid, n in ((0, 7), (1, 10))]
    _, cb = _drain_logits(cfg, params, reqs, telemetry=tel)
    counts = {m.name: m.value for m in tel.registry.find("moe_pairs")
              + tel.registry.find("moe_layer_calls")}
    decodes = sum(1 for s in tel.span_records()
                  if s.name == "serve/paged_decode")
    prefills = sum(1 for s in tel.span_records()
                   if s.name == "serve/paged_prefill")
    rows = decodes * cb.n_slots + cb.prefill_tokens
    assert counts["moe_pairs"] == cfg.top_k * cfg.n_layers * rows
    assert counts["moe_layer_calls"] == cfg.n_layers * (decodes + prefills)
    spans = [s for s in tel.span_records() if s.name == "model/moe"]
    assert len(spans) == cfg.n_layers * (decodes + prefills)


def test_k6_plain_equals_a_per_expert_loop():
    """K6's plain version gives, on each expert's rows, K3's plain version
    on that expert's planes (exactly); `ops.bitplane_grouped_matmul`
    gives each row its own expert's `bitplane_matmul`, with empty
    experts and uneven counts."""
    gen = torch.Generator().manual_seed(0)
    e, k, m = 6, 64, 40
    planes, scale = zip(*(ops.quantize_and_pack(
        torch.randn(k, m, generator=gen), 8, 1, impl="ref")
        for _ in range(e)))
    planes, scale = torch.stack(planes), torch.stack(scale)
    counts = [5, 0, 1, 12, 0, 3]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32)
    expert = torch.repeat_interleave(torch.arange(e), torch.tensor(counts))
    x = torch.randn(sum(counts), k, generator=gen)
    raw = bitplane_grouped.bitplane_grouped(ref.prepare_x_ref(x), planes,
                                            offsets, n_bits=8)
    y = ops.bitplane_grouped_matmul(x, planes, scale, offsets, expert,
                                    n_bits=8, impl="ref")
    for i, (a, b) in enumerate(zip(offsets[:-1].tolist(),
                                   offsets[1:].tolist())):
        # K3's plain over every row, as the plain K6 runs it: a CPU
        # matmul's sums for one row may follow the number of rows
        want = bitplane_gemv.bitplane_gemv(
            ref.prepare_x_ref(x).contiguous(), planes[i], n_bits=8)
        assert torch.equal(raw[a:b], want[a:b])
        torch.testing.assert_close(y[a:b], ops.bitplane_matmul(
            x[a:b], planes[i], scale[i], n_bits=8, impl="ref"),
            rtol=1e-6, atol=1e-6)
    assert bitplane_grouped.LAUNCHES == 0


def test_yarn_at_the_published_numbers():
    """The global layers' frequencies and scale at the published numbers
    (d = 128, theta 5e5, factor 16 over 8192, beta 32 / 1, attention
    factor 1.27726) equal YaRN written out by hand: low = 18, high =
    35; the windowed layers keep plain RoPE at the same theta."""
    cfg = get_config(ARCH)
    assert ARCH not in ARCH_IDS
    assert [l for l in range(cfg.n_layers) if cfg.is_global(l)] == list(
        range(3, 28, 4))
    assert cfg.layer_rope(0) == cfg.layer_rope(26) == 500_000.0
    yarn = cfg.layer_rope(27)
    assert isinstance(yarn, Yarn)
    d, theta = 128, 500_000.0
    low = math.floor(d * math.log(8192 / (32 * 2 * math.pi))
                     / (2 * math.log(theta)))
    high = math.ceil(d * math.log(8192 / (1 * 2 * math.pi))
                     / (2 * math.log(theta)))
    assert (low, high) == (18, 35)
    want = []
    for i in range(d // 2):
        extrap = theta ** (-2 * i / d)
        gamma = 1 - min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(extrap * gamma + extrap / 16 * (1 - gamma))
    got = rope_frequencies(d, yarn, "cpu").double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    plain_f = rope_frequencies(d, theta, "cpu")
    assert torch.equal(plain_f[:low], rope_frequencies(d, yarn, "cpu")[:low])
    x = torch.ones(1, 1, 1, d)
    pos = torch.zeros(1, 1, dtype=torch.int64)
    # at position 0 the rotation is the identity times the factor
    torch.testing.assert_close(apply_rope(x, pos, yarn),
                               x * 1.2772588722239782, rtol=1e-6, atol=0)

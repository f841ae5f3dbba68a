"""A run whose timed path is broken underneath comes out not correct: once
for each fault a serving cell can have. The run skips the look for a
chip (`--device cpu`) and is otherwise the whole run: warm-up, traffic,
window, sample, reference."""

import time

import pytest
import torch

from bench import run as bench_run
from bench.tests import bench_fixture
from repro_torch.models import transformer
from repro_torch.serve.scheduler import ContinuousBatcher


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    root = bench_fixture.make(tmp_path_factory.mktemp("faults"))
    return root, bench_run.load_cell(root, bench_fixture.CELL)


def one_run(cell, seed=21):
    root, c = cell
    return bench_run.run(root, c, seed, 1.0, False, torch.device("cpu"),
                         time.perf_counter())


def test_sound_run_is_correct(cell):
    assert one_run(cell)["correct"] is True


def test_decoded_token_altered(cell, monkeypatch):
    orig = ContinuousBatcher._step_paged
    vocab = cell[1]["config"]["model"]["vocab_size"]

    def altered(self, active):
        nxt = orig(self, active)
        nxt[active[0]] = (nxt[active[0]] + 1) % vocab
        return nxt
    monkeypatch.setattr(ContinuousBatcher, "_step_paged", altered)
    res = one_run(cell)
    assert res["correct"] is False
    assert res["checks"]["widest_gap"]["value"] > 1e-3


def test_first_token_altered(cell, monkeypatch):
    orig = ContinuousBatcher._start_slot

    def altered(self, i, req, logits):
        return orig(self, i, req, torch.roll(logits, 1, dims=-1))
    monkeypatch.setattr(ContinuousBatcher, "_start_slot", altered)
    assert one_run(cell)["correct"] is False


def test_decode_leaves_the_cache_unchanged(cell, monkeypatch):
    orig = transformer.attention_decode_paged

    def stale(p, h, positions, k_pages, v_pages, *args, **kw):
        k0, v0 = k_pages.clone(), v_pages.clone()
        out = orig(p, h, positions, k_pages, v_pages, *args, **kw)
        k_pages.copy_(k0)
        v_pages.copy_(v0)
        return out
    monkeypatch.setattr(transformer, "attention_decode_paged", stale)
    assert one_run(cell)["correct"] is False


def test_requests_cut_short(cell, monkeypatch):
    orig = ContinuousBatcher.submit

    def short(self, req):
        req.max_new_tokens = max(1, req.max_new_tokens - 1)
        return orig(self, req)
    monkeypatch.setattr(ContinuousBatcher, "submit", short)
    res = one_run(cell)
    assert res["correct"] is False
    assert res["checks"]["short_tokens"]["value"] > 0

"""The traffic generator: the same seed draws the same requests and
arrivals; each seed draws its own, independently, within the mix's
bounds."""

import math

import numpy as np

from bench.traffic import Stream

MIX = {"loop": "open", "rate_per_s": 3.0, "slots": 4,
       "prompt_tokens": {"min": 1024, "max": 4096},
       "output_tokens": {"min": 16, "max": 64}}


def draws(seed, n=200, mix=MIX):
    s = Stream(mix, 152064, seed)
    return [s.next() for _ in range(n)]


def test_same_seed_same_requests_and_arrivals():
    a, b = draws(2_500_000_017), draws(2_500_000_017)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new_tokens, x.gap_s) == (y.max_new_tokens, y.gap_s)


def test_seeds_draw_their_own_schedules():
    a, b = draws(1), draws(2)
    assert [d.prompt.shape[0] for d in a] != [d.prompt.shape[0] for d in b]
    assert [d.gap_s for d in a] != [d.gap_s for d in b]


def test_gaps_are_exponential_at_the_rate():
    gaps = np.array([d.gap_s for d in draws(7, 20_000)])
    assert gaps.min() > 0
    # mean 1 / rate and coefficient of variation 1, as a Poisson process
    assert abs(gaps.mean() * 3.0 - 1) < 0.03
    assert abs(gaps.std() / gaps.mean() - 1) < 0.03
    # no stratification: a block of 64 does not fill 64 / rate seconds
    spans = gaps[: 64 * 100].reshape(100, 64).sum(axis=1) * 3.0 / 64
    assert spans.std() > 0.08


def test_lengths_log_uniform_within_bounds():
    a = draws(5, 4000)
    plen = np.array([d.prompt.shape[0] for d in a])
    olen = np.array([d.max_new_tokens for d in a])
    assert plen.min() >= 1024 and plen.max() <= 4096
    assert olen.min() >= 16 and olen.max() <= 64
    # log-uniform: the median sits at the geometric mean, the mean at
    # (hi - lo) / ln(hi / lo)
    assert abs(np.median(plen) - 2048) < 60
    assert abs(plen.mean() - 3072 / math.log(4)) < 40
    assert all(0 <= d.prompt.min() and d.prompt.max() < 152064
               for d in a[:64])


def test_closed_loop_draws_no_gaps():
    mix = dict(MIX, loop="closed", clients=4, rate_per_s=None)
    assert all(d.gap_s == 0.0 for d in draws(3, 50, mix))


def test_first_wave_residuals():
    mix = dict(MIX, loop="closed", clients=100, first_wave_residual=True)
    plain = Stream(dict(mix, first_wave_residual=False), 1000, 9)
    resid = Stream(mix, 1000, 9)
    full = plain.first_wave(100)
    cut = resid.first_wave(100)
    assert all(1 <= c.max_new_tokens <= f.max_new_tokens
               for c, f in zip(cut, full))
    assert any(c.max_new_tokens < f.max_new_tokens for c, f in zip(cut, full))
    # the stream after the first wave is the same either way
    assert plain.next().max_new_tokens == resid.next().max_new_tokens

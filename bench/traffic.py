"""The one traffic generator: reads a traffic mix's parameters and draws
its requests from the seed.

A mix (`bench/traffic/<name>.json`) gives:

  source          where its lengths (and, in an open loop, its arrivals)
                  come from: a public trace or dataset and the statistics
                  of it that the bounds below reproduce
  loop            "open" (requests fall due on a schedule, whatever the
                  system does) or "closed" (`clients` callers, each sending
                  its next request when its last one finished, after
                  `think_s`)
  rate_per_s      open loop: mean arrivals per second (Poisson)
  clients         closed loop: callers
  slots           decode slots of the batcher
  prompt_tokens   {"min", "max"}: prompt lengths, log-uniform
  output_tokens   {"min", "max"}: `max_new_tokens`, log-uniform
  warm_s          seconds of traffic before the window opens
  first_wave_residual
                  closed loop: the first request of each client gets the
                  residual of its drawn output (uniform in 1..drawn), so
                  slots free at staggered times from the start
  follow_s        how long past the window's close requests due in it are
                  followed to their end
  check           {"served_tokens"}: the output check's sample size

Every draw is independent: lengths log-uniform between their bounds,
inter-arrival gaps exponential (a Poisson process), token ids uniform
over the vocabulary. The seed draws all of them, so each seed has its own
schedule. No prompt shares a prefix with another beyond chance.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np


@dataclasses.dataclass
class Draw:
    index: int
    prompt: np.ndarray           # int32 token ids
    max_new_tokens: int
    gap_s: float                 # open loop: seconds after the previous


def loguniform(rng: np.random.Generator, lo: int, hi: int) -> int:
    v = math.exp(rng.uniform(math.log(lo), math.log(hi)))
    return int(min(max(round(v), lo), hi))


class Stream:
    """The requests of one run, in the order they are sent."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.t = traffic
        self.vocab = vocab
        sizes, tokens, resid = np.random.SeedSequence(seed).spawn(3)
        self._sizes = np.random.default_rng(sizes)
        self._tokens = np.random.default_rng(tokens)
        self._resid = np.random.default_rng(resid)
        self.rate = traffic.get("rate_per_s")
        self.count = 0

    def next(self) -> Draw:
        p, o = self.t["prompt_tokens"], self.t["output_tokens"]
        plen = loguniform(self._sizes, p["min"], p["max"])
        olen = loguniform(self._sizes, o["min"], o["max"])
        gap = (float(self._sizes.exponential(1.0 / self.rate))
               if self.rate else 0.0)
        prompt = self._tokens.integers(0, self.vocab, plen, dtype=np.int32)
        d = Draw(self.count, prompt, olen, gap)
        self.count += 1
        return d

    def first_wave(self, n: int) -> List[Draw]:
        """The closed loop's first request of each of `n` clients."""
        out = []
        for _ in range(n):
            d = self.next()
            if self.t.get("first_wave_residual"):
                d.max_new_tokens = int(self._resid.integers(
                    1, d.max_new_tokens + 1))
            out.append(d)
        return out

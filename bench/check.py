"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample of
the requests it finished, drawn from the seed with the longest among
them, is run through the plain reference (`models/<family>.py`, f32, on
weights drawn again from the seed): each prompt followed by its served
tokens, in one forward pass. Two numbers are compared:

  widest_gap   the largest amount by which a served token's logit lies
               below the reference's best logit at that position, over
               every served token of the sample (greedy serving picks
               the best token; rounding may pick a near tie)
  short_tokens requests of the sample (and of the whole window) that
               ended with another number of tokens than they asked for

`control_gaps` reads the same sample in the reference at a lower
precision (the control): at each position, the f32 reference's gap of
the token the lower precision puts first.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def sample(reqs, served_tokens: int, seed: int) -> List:
    """The longest request (prompt and output), then others in an order
    drawn from the seed, until the sample holds `served_tokens` served
    tokens."""
    done = [r for r in reqs if r.tokens]
    if not done:
        return []
    done.sort(key=lambda r: r.uid)
    longest = max(done, key=lambda r: (r.prompt_len + len(r.tokens), r.uid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng([seed, 7]).permutation(len(rest))
    out, n = [longest], len(longest.tokens)
    for i in order:
        if n >= served_tokens:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


def _sequences(picked, device):
    seqs, starts = [], []
    for r in picked:
        toks = np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)])
        seqs.append(torch.as_tensor(toks, device=device))
        starts.append(r.prompt_len - 1)
    return seqs, starts


def _served(config: dict):
    w = config["serving"]["weights"]
    return f"int{w['n_bits']}" if w["kind"] == "bitplane" else None


def reference(family, config: dict, seed: int, picked, device):
    """f32 reference logits of each picked request at its served
    positions, on weights drawn again from the seed."""
    params = family.make_params(config["model"], seed, device)
    seqs, starts = _sequences(picked, device)
    logits = family.reference_logits(params, config["model"], seqs, starts,
                                     served=_served(config))
    del params
    return logits


def gaps(logits, chosen) -> np.ndarray:
    """Per position: the best logit minus the logit of `chosen`."""
    out = []
    for lg, ch in zip(logits, chosen):
        ch = torch.as_tensor(np.asarray(ch), device=lg.device).long()
        best = lg.max(dim=-1).values
        out.append((best - lg.gather(1, ch[:, None])[:, 0]).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def judge(family, config: dict, seed: int, picked, device) -> Dict:
    logits = reference(family, config, seed, picked, device)
    g = gaps(logits, [r.tokens for r in picked])
    return {"widest_gap": float(g.max()) if g.size else None,
            "mean_gap": float(g.mean()) if g.size else None,
            "sampled_requests": len(picked), "sampled_tokens": int(g.size),
            "logits": logits}


def control_gaps(family, config: dict, seed: int, picked, logits, device,
                 weights, acts) -> np.ndarray:
    """The f32 reference's gap of the token the control (the reference
    with `weights` / `acts` codes) puts first, at every served position."""
    params = family.make_params(config["model"], seed, device)
    seqs, starts = _sequences(picked, device)
    low = family.reference_logits(params, config["model"], seqs, starts,
                                  weights=weights, acts=acts)
    del params
    return gaps(logits, [lg.argmax(dim=-1).cpu().numpy() for lg in low])

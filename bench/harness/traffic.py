"""The one traffic generator: a mix's JSON file of parameters -> a seeded
schedule of requests.

A mix (``bench/traffic/<name>.json``) gives:

* ``kind``: ``"open_loop"`` (Poisson arrivals at ``rate_rps``, drawn by the
  frozen thinning sampler) or ``"offline"`` (``queue_per_s`` times the
  horizon requests, all due at the start);
* ``warm_s``: the span of the mix served before the window opens;
* ``prompt``: lognormal lengths (``median``, ``sigma``) clipped to
  [``min``, ``max``]; ``output``: uniform over [``min``, ``max``], exact
  (no end-of-sequence token);
* ``temperature`` and ``greedy_share`` (the share served greedily, which
  the check compares);
* ``shape_seed``: the seed of the sizes and arrivals.

Every run of a mix at one length gets the same requests in the same
order: arrival times, prompt and output lengths and which requests are
greedy all follow ``shape_seed``.  The run's seed draws only the tokens
(and, elsewhere, the weights), so two seeds do the same work at the same
times, and the same prefill shapes are warmed up in every run.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Set, Tuple

import numpy as np

from harness.frozen import sample_arrival_times


@dataclass
class Item:
    rid: int
    due: float                 # seconds from the schedule's start
    prompt: np.ndarray         # (P,) int32
    max_new: int
    temperature: float


def sizes(mix: dict, seconds: float) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray]:
    """(arrival times, prompt lengths, output lengths, greedy flags) of a
    mix over ``warm_s + seconds``: fixed by ``shape_seed`` alone."""
    rng = np.random.default_rng(int(mix["shape_seed"]))
    horizon = float(mix["warm_s"]) + float(seconds)
    if mix["kind"] == "open_loop":
        rate = float(mix["rate_rps"])
        times = sample_arrival_times(lambda t: rate, horizon, rng,
                                     rate_max=rate)
    elif mix["kind"] == "offline":
        times = np.zeros(int(math.ceil(float(mix["queue_per_s"]) * horizon)))
    else:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    n = len(times)
    p, o = mix["prompt"], mix["output"]
    raw = np.exp(rng.normal(math.log(p["median"]), p["sigma"], n))
    plen = np.clip(np.rint(raw), p["min"], p["max"]).astype(np.int64)
    olen = rng.integers(o["min"], o["max"] + 1, n).astype(np.int64)
    greedy = np.ones(n, bool)
    if float(mix.get("temperature", 0.0)) > 0.0:
        # a share of the requests, spread over the arrivals
        k = int(round(n * float(mix["greedy_share"])))
        greedy = rng.permutation(n) < k
    return times, plen, olen, greedy


def schedule(mix: dict, seconds: float, seed: int,
             vocab: int) -> List[Item]:
    """The run's requests in order of arrival: the mix's requests (arrival,
    prompt length, output length, greedy or not) as :func:`sizes` gives
    them, tokens drawn by ``seed`` uniformly over the vocabulary."""
    times, plen, olen, greedy = sizes(mix, seconds)
    rng = np.random.default_rng(int(seed))
    temp = float(mix.get("temperature", 0.0))
    out = []
    for i, t in enumerate(times):
        prompt = rng.integers(0, vocab, int(plen[i])).astype(np.int32)
        out.append(Item(i, float(t), prompt, int(olen[i]),
                        0.0 if greedy[i] else temp))
    return out


def prefill_shapes(prompt_lens, chunk: int) -> Set[Tuple[str, int]]:
    """The (variant, length) pairs the engine's prefill runs for these
    prompts: a prompt within one chunk is prefilled whole (``prefill``),
    a longer one in chunks of ``chunk`` and a remainder (``chunk``)."""
    out = set()
    for n in prompt_lens:
        n = int(n)
        if chunk <= 0 or n <= chunk:
            out.add(("prefill", n))
        else:
            out.add(("chunk", chunk))
            out.add(("chunk", n - chunk * ((n - 1) // chunk)))
    return out


def warm_lengths(shapes, chunk: int) -> List[int]:
    """One prompt length per shape that makes the engine run it: the
    length itself for a whole prompt, a chunk plus the remainder for a
    chunk length."""
    return sorted(n if kind == "prefill" else chunk + n
                  for kind, n in shapes)

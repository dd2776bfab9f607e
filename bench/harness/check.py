"""``correct``: the served tokens against the plain reference.

Once the window has closed, two samples of the requests it finished,
each drawn from the seed with the longest among them, go through the
reference (``bench/reference``) in float32, prompt and served tokens
together: ``sample`` greedy requests and ``sample_sampled`` requests
drawn at a temperature.

* A greedy token's gap is how far its reference logit lies below the
  reference's best (0 where they agree).
* A sampled token is a draw from the reference's distribution at the
  request's temperature T, p_T = softmax(logits / T).  Over a sample's
  served positions, log p_T(token) + H(p_T) has mean 0 and variance
  Var(log p_T) under p_T, so ``sample_z_abs``, the absolute sum of the
  one over the square root of the sum of the other, is a standard
  normal's size where the tokens follow p_T.  A sampler that returns the
  argmax, or draws at another temperature, reads far above it; which of
  the draws of p_T it takes (its random stream) is not judged.

What is compared, and each limit, is the cell's own file
``bench/limits/<workload>.json``: the sample sizes, and under ``limits``
a bound on any of :func:`summary`'s numbers.  Besides, the expert tier
dropped no token and missed no expert (``dropped``, ``miss``: exact,
limit 0), and some greedy tokens were compared.

The control (:func:`readings` with a ``cast``) is the reference in a
lower precision put in the program's place: at the same positions it
takes the token that its own logits put first, or draws one from them
at the request's temperature, and the same comparison judges it.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from harness import weights

Served = Sequence[Tuple[np.ndarray, list]]
# tokens the reference takes through a layer at once
BLOCK_TOKENS = 12288


def load_limits(root: Path, workload: str) -> Dict:
    return json.loads((root / "bench" / "limits"
                       / f"{workload}.json").read_text())


def pick(driver, ws: float, we: float, n: int, rng,
         sampled: bool = False) -> List[int]:
    """Up to ``n`` greedy requests (with ``sampled``: requests drawn at a
    temperature) that finished inside the window: the longest (prompt
    plus served tokens), and the rest drawn by ``rng``."""
    if n <= 0:
        return []
    cands = sorted(rid for rid, tk in driver.tracks.items()
                   if tk.done and tk.times and ws <= tk.times[-1] <= we
                   and (driver.reqs[rid].sampling.temperature > 0.0)
                   == sampled)
    if not cands:
        return []

    def size(rid):
        r = driver.reqs[rid]
        return len(r.prompt) + len(r.output_tokens)
    first = max(cands, key=lambda r: (size(r), -r))
    rest = [r for r in cands if r != first]
    k = min(n - 1, len(rest))
    drawn = list(rng.choice(rest, size=k, replace=False)) if k else []
    return [first] + sorted(int(r) for r in drawn)


def draw_samples(driver, ws: float, we: float, limits: Dict,
                 seed: int) -> Tuple[List[int], List[int]]:
    """(greedy request ids, sampled request ids) that a run of ``seed``
    compares, as many as the cell's limits file says."""
    return (pick(driver, ws, we, int(limits["sample"]),
                 np.random.default_rng([seed, 11])),
            pick(driver, ws, we, int(limits.get("sample_sampled", 0)),
                 np.random.default_rng([seed, 12]), sampled=True))


def served(driver, rids) -> List[Tuple[np.ndarray, list]]:
    """(prompt, served tokens) of each request."""
    return [(np.asarray(driver.reqs[r].prompt, np.int64),
             list(driver.reqs[r].output_tokens)) for r in rids]


def temperatures(driver, rids) -> List[float]:
    return [float(driver.reqs[r].sampling.temperature) for r in rids]


def reference_module(config: dict):
    return importlib.import_module("reference." + config["reference"])


def _inputs(sv: Served, device):
    """Each request's sequence (prompt and served tokens but the last) and
    the positions whose logits chose a served token."""
    seqs, at = [], []
    for prompt, out in sv:
        full = np.concatenate([prompt, np.asarray(out[:-1], np.int64)])
        seqs.append(torch.as_tensor(full, device=device))
        at.append(torch.arange(len(prompt) - 1, len(full), device=device))
    return seqs, at


def _blocks(sv: Served, budget: int):
    """The requests in consecutive blocks of at most ``budget`` tokens (a
    longer request alone), so that the reference's activations fit."""
    block, n = [], 0
    for i, (prompt, out) in enumerate(sv):
        size = len(prompt) + len(out)
        if block and n + size > budget:
            yield block
            block, n = [], 0
        block.append(i)
        n += size
    if block:
        yield block


def _logits(ref, W, m: dict, sv: Served, device, **kw):
    """The reference's logits at each request's served positions, block
    by block."""
    out = [None] * len(sv)
    for block in _blocks(sv, BLOCK_TOKENS):
        seqs, at = _inputs([sv[i] for i in block], device)
        for i, lg in zip(block, ref.logits_at(W, m, seqs, at, **kw)):
            out[i] = lg
    return out


def _gap(ref: torch.Tensor, toks: torch.Tensor) -> List[float]:
    best = ref.max(-1).values
    return (best - ref.gather(1, toks[:, None])[:, 0]).tolist()


def _draw(ref: torch.Tensor, toks: torch.Tensor, temp: float,
          rows: int = 256) -> List[float]:
    """[sum of log p_T(token) + H(p_T), sum of Var(log p_T) under p_T,
    tokens] over a sampled request's served positions, p_T the
    reference's distribution at temperature ``temp`` (float64)."""
    dev, var = 0.0, 0.0
    for i in range(0, ref.shape[0], rows):
        lp = torch.log_softmax(ref[i:i + rows].double() / temp, -1)
        p = lp.exp()
        h = -(p * lp).sum(-1)
        var += float(((p * lp * lp).sum(-1) - h * h).sum())
        tk = toks[i:i + rows, None]
        dev += float((lp.gather(1, tk)[:, 0] + h).sum())
    return [dev, var, int(ref.shape[0])]


def readings(params, m: dict, greedy: Served, sampled: Served,
             temps: Sequence[float], device, config: dict, cast=None,
             seed: int = 0) -> Tuple[List[List[float]], List[List[float]]]:
    """(per greedy request, each served token's gap; per sampled request,
    :func:`_draw` of its served tokens).  With ``cast`` (a lower
    precision), the control in the program's place: at the same positions
    the token that the reference computed through ``cast`` puts first, or
    draws at the request's temperature (a generator seeded by ``seed``)."""
    sv = list(greedy) + list(sampled)
    if not sv:
        return [], []
    ref = reference_module(config)
    W = weights.plain(params, m)
    hi = _logits(ref, W, m, sv, device)
    ng = len(greedy)
    if cast is None:
        toks = [torch.as_tensor(t, device=lg.device)
                for (_, t), lg in zip(sv, hi)]
    else:
        lo = _logits(ref, W, m, sv, device, cast=cast)
        gen = torch.Generator(lo[0].device).manual_seed(int(seed))
        toks = [lg.argmax(-1) for lg in lo[:ng]]
        for lg, t in zip(lo[ng:], temps):
            p = torch.softmax(lg / t, -1)
            toks.append(torch.multinomial(p, 1, generator=gen)[:, 0])
        del lo
    gaps = [_gap(hi[i], toks[i]) for i in range(ng)]
    draws = [_draw(hi[ng + j], toks[ng + j], t)
             for j, t in enumerate(temps)]
    return gaps, draws


def summary(g: List[List[float]],
            draws: Sequence[Sequence[float]] = ()) -> Dict[str, float]:
    """The numbers a limit can bound: over every compared greedy token
    ``gap_mean``, ``gap_max``, ``request_gap_mean_max`` (the worst
    request's mean), ``mismatch_share`` (tokens whose gap is above 0);
    over the sampled requests' tokens ``sample_z_abs``."""
    flat = [v for x in g for v in x]
    s = {"tokens": len(flat)}
    if flat:
        s.update(gap_mean=float(np.mean(flat)), gap_max=float(max(flat)),
                 request_gap_mean_max=float(max(np.mean(x)
                                                for x in g if x)),
                 mismatch_share=sum(1 for v in flat if v > 0) / len(flat))
    n = sum(d[2] for d in draws)
    if n:
        var = sum(d[1] for d in draws)
        s["sampled_tokens"] = n
        s["sample_z_abs"] = abs(sum(d[0] for d in draws)) \
            / max(var, 1e-300) ** 0.5
    return s


def judge(g: List[List[float]], draws: Sequence[Sequence[float]],
          dropped: int, miss: int, limits: Dict) -> Tuple[bool, int, Dict]:
    """(correct, requests failed, {name: [number, limit]}) of one run."""
    s = summary(g, draws)
    compared = {}
    ok = True
    for name, lim in limits["limits"].items():
        v = s.get(name)
        compared[name] = [v, lim]
        ok = ok and v is not None and lim is not None and v <= lim
    compared["compared_tokens"] = [s["tokens"], "> 0"]
    if "sample_z_abs" in limits["limits"]:
        compared["sampled_tokens"] = [s.get("sampled_tokens", 0), "> 0"]
    compared["dropped"] = [int(dropped), 0]
    compared["miss"] = [int(miss), 0]
    ok = ok and s["tokens"] > 0 and dropped == 0 and miss == 0
    # a request fails when its own tokens break a limit on its numbers
    failed = 0
    for sx in [summary([x]) for x in g] + [summary([], [d]) for d in draws]:
        if any(n in sx and (lim is None or sx[n] > lim)
               for n, lim in limits["limits"].items()):
            failed += 1
    return ok, failed, compared

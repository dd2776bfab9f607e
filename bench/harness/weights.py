"""The benchmark's weights, made on the device from the seed.

One ``torch.Generator`` on the device draws every leaf, in the type it is
served in, a few large calls per leaf.  The leaves are laid out as the
port's ``ServingEngine`` takes its ``params`` (layers stacked, each MoE
layer's experts in the servers' ``(S, slots, in, out)`` layout: expert
``e``'s primary at server ``e // (E / S)``, slot ``e % (E / S)``, the
redundant slots after them), so the same tensors serve the program and,
through :func:`plain`, the reference: there is room for only one copy.
The redundant slots are copies the benchmark writes itself
(:func:`fill_redundant`) from the pool's table; the reference reads the
primaries.

The embeddings are drawn N(0, 1): each token's own vector then dominates
the residual stream, as the router of a trained model needs to spread a
prompt's tokens over the experts.  (At N(0, 0.02) the attention's average
over the context dominates instead, every token of a prompt routes alike,
and a 512-token chunk overflows a server's buffer.)
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

BF16 = torch.bfloat16
EMBED_STD = 1.0
ROUTER_STD = 0.02


class _Draw:
    """Draws leaves into new tensors, or, given ``into``, into the same
    tensors of an earlier draw, in place (their addresses kept)."""

    def __init__(self, seed: int, device, into: Optional[Dict]):
        self.device = torch.device(device)
        self.gen = torch.Generator(self.device).manual_seed(int(seed))
        self.into = into

    def _old(self, path):
        t = self.into
        for k in path:
            t = t[k]
        return t

    def normal(self, path, shape, std: float, dtype=BF16) -> torch.Tensor:
        t = (self._old(path) if self.into is not None
             else torch.empty(shape, dtype=dtype, device=self.device))
        return t.normal_(0.0, std, generator=self.gen)

    def linear(self, path, lead, fan_in: int, fan_out: int) -> torch.Tensor:
        return self.normal(path, (*lead, fan_in, fan_out),
                           1.0 / math.sqrt(fan_in))

    def ones(self, path, shape) -> torch.Tensor:
        if self.into is not None:
            return self._old(path).fill_(1.0)
        return torch.ones(shape, dtype=torch.float32, device=self.device)


def _mlp(dr: _Draw, path, lead, d: int, f: int) -> Dict:
    return {"w_gate": dr.linear(path + ("w_gate",), lead, d, f),
            "w_up": dr.linear(path + ("w_up",), lead, d, f),
            "w_down": dr.linear(path + ("w_down",), lead, f, d)}


def _block(dr: _Draw, name: str, m: dict, n: int) -> Dict:
    d, hd = m["d_model"], m["d_head"]
    h, kv = m["num_heads"], m["num_kv_heads"]
    a = (name, "attn")
    return {"ln1": dr.ones((name, "ln1"), (n, d)),
            "ln2": dr.ones((name, "ln2"), (n, d)),
            "attn": {"wq": dr.linear(a + ("wq",), (n,), d, h * hd),
                     "wk": dr.linear(a + ("wk",), (n,), d, kv * hd),
                     "wv": dr.linear(a + ("wv",), (n,), d, kv * hd),
                     "wo": dr.linear(a + ("wo",), (n,), h * hd, d)}}


@torch.no_grad()
def make(m: dict, num_servers: int, n_redundant: int, seed: int, device,
         into: Optional[Dict] = None) -> Dict:
    """The params of model sizes ``m`` (a configuration's ``model``) over
    ``num_servers`` expert servers with ``n_redundant`` redundant slots
    each, drawn from ``seed``: embeddings N(0, 1), projections
    N(0, 1 / fan_in), the router N(0, 0.02) in float32, norms ones.
    ``into``: redraw an earlier draw's tensors in place (the same values
    as a fresh draw from ``seed``)."""
    dr = _Draw(seed, device, into)
    d, V = m["d_model"], m["vocab_size"]
    n_dense = m["num_dense_layers"]
    n_moe = m["num_layers"] - n_dense
    p = {"embed": dr.normal(("embed",), (V, d), EMBED_STD),
         "final_ln": dr.ones(("final_ln",), (d,))}
    if n_moe:
        E, S, f = m["num_experts"], num_servers, m["d_expert"]
        per = E // S
        blk = _block(dr, "blocks", m, n_moe)
        servers = {}
        for name, (a, b) in (("w_gate", (d, f)), ("w_up", (d, f)),
                             ("w_down", (f, d))):
            w = (dr._old(("blocks", "moe", "servers", name)) if into
                 else torch.zeros((n_moe, S, per + n_redundant, a, b),
                                  dtype=BF16, device=dr.device))
            for s in range(S):
                w[:, s, :per].normal_(0.0, 1.0 / math.sqrt(a),
                                      generator=dr.gen)
            servers[name] = w
        mp = ("blocks", "moe")
        moe = {"router": {"w_router": dr.normal(
                   mp + ("router", "w_router"), (n_moe, d, E), ROUTER_STD,
                   torch.float32)},
               "servers": servers}
        if m["num_shared_experts"]:
            moe["shared"] = _mlp(dr, mp + ("shared",), (n_moe,), d,
                                 f * m["num_shared_experts"])
        if m["dense_residual"]:
            moe["residual"] = _mlp(dr, mp + ("residual",), (n_moe,), d,
                                   m["d_ff"])
        blk["moe"] = moe
        p["blocks"] = blk
    if n_dense:
        blk = _block(dr, "dense_blocks", m, n_dense)
        blk["mlp"] = _mlp(dr, ("dense_blocks", "mlp"), (n_dense,), d,
                          m["d_ff"])
        p["dense_blocks"] = blk
    p["head"] = dr.linear(("head",), (), d, V)
    return p


@torch.no_grad()
def fill_redundant(params: Dict, m: dict, redundant_table) -> None:
    """Copy each redundant slot's expert from its primary (the pool's
    ``(S, n_redundant)`` table of expert ids; -1 leaves a slot zero)."""
    if "blocks" not in params or "moe" not in params["blocks"]:
        return
    servers = params["blocks"]["moe"]["servers"]
    S = servers["w_gate"].shape[1]
    table = np.asarray(redundant_table).reshape(S, -1)
    per = m["num_experts"] // S
    for w in servers.values():
        for s in range(S):
            for j, e in enumerate(table[s]):
                if e >= 0:
                    w[:, s, per + j].copy_(w[:, e // per, e % per])
                else:
                    w[:, s, per + j].zero_()


def plain(params: Dict, m: dict) -> Dict:
    """The reference's view of the same tensors: one dict per layer, in
    order, each expert ``e`` of an MoE layer read at its primary."""
    n_dense = m["num_dense_layers"]
    layers = []
    for i in range(m["num_layers"]):
        if i < n_dense:
            b, j = params["dense_blocks"], i
        else:
            b, j = params["blocks"], i - n_dense
        lay = {"ln1": b["ln1"][j], "ln2": b["ln2"][j],
               **{k: v[j] for k, v in b["attn"].items()}}
        if "mlp" in b:
            lay["mlp"] = {k: v[j] for k, v in b["mlp"].items()}
        else:
            mo = b["moe"]
            sv = mo["servers"]
            lay["router"] = mo["router"]["w_router"][j]
            # (S, slots, in, out): expert e at [e // per, e % per]
            lay["experts"] = {k: v[j] for k, v in sv.items()}
            lay["per_server"] = m["num_experts"] // sv["w_gate"].shape[1]
            for extra in ("shared", "residual"):
                if extra in mo:
                    lay[extra] = {k: v[j] for k, v in mo[extra].items()}
        layers.append(lay)
    return {"embed": params["embed"], "final_ln": params["final_ln"],
            "head": params["head"], "layers": layers}

"""The benchmark's own count of the model's useful operations.

A token that passes through the model costs 2 x the parameters it
touches (every weight a multiply and an add): the attention projections,
the dense FFN, the router, its top-k routed experts plus the shared ones
or Arctic's dense residual, and the head where the step produces that
token's logits.  Attention adds 4 x context x heads x head size a layer
(q k^T and p v over the positions it attends to).  Top-k is fixed, so
the count is exact from the shapes and from the token counts and
positions the harness knows; rows the program computes for idle slots
or masked positions are not useful work and are not counted.
"""

from __future__ import annotations


def layer_params(m: dict, dense: bool) -> int:
    """Weights a token touches in one layer."""
    d, hd = m["d_model"], m["d_head"]
    attn = d * m["num_heads"] * hd * 2 + d * m["num_kv_heads"] * hd * 2
    if dense:
        return attn + 3 * d * m["d_ff"]
    ffn = d * m["num_experts"] + 3 * d * m["d_expert"] * (
        m["top_k"] + m["num_shared_experts"])
    if m["dense_residual"]:
        ffn += 3 * d * m["d_ff"]
    return attn + ffn


def token_flops(m: dict, context: int, head: bool) -> float:
    """Operations of one token that attends over ``context`` positions
    (its own included), with its logits if ``head``."""
    n_dense = m["num_dense_layers"]
    n_moe = m["num_layers"] - n_dense
    params = (n_dense * layer_params(m, True)
              + n_moe * layer_params(m, False)
              + (m["d_model"] * m["vocab_size"] if head else 0))
    attn = 4 * context * m["num_heads"] * m["d_head"] * m["num_layers"]
    return 2.0 * params + attn


def chunk_flops(m: dict, start: int, length: int, head: bool) -> float:
    """A prefill chunk of ``length`` tokens at positions [start, start +
    length), the last with its logits if ``head``: the tokens' parameter
    work plus attention over 1 + 2 + ... contexts."""
    if length <= 0:
        return 0.0
    base = token_flops(m, 0, False) * length
    ctx = length * start + length * (length + 1) // 2
    attn = 4 * ctx * m["num_heads"] * m["d_head"] * m["num_layers"]
    extra = 2.0 * m["d_model"] * m["vocab_size"] if head else 0.0
    return base + attn + extra

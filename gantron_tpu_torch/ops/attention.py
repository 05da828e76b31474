"""Additive attention over the whole (frames x characters) grid.

``additive_attention`` scores every frame against every character at once,
``e[b, t, j] = v . tanh(q[b, t] + k[b, j])``, so that a teacher-forced pass
computes the attention of all its frames in one call. It materialises the
(B, T, T_in, A) grid of ``tanh`` (and autograd keeps it for the backward);
``additive_attention.energy_elements`` counts the grid's elements over every
call, so that a fused kernel can show what it no longer materialises.
"""

import torch


def additive_attention(q, keys, values, v, mask):
    """q (B, T, A), keys (B, T_in, A), values (B, T_in, D), v (A, 1), mask
    (B, T_in) true at each text's characters. Scores past a text's length
    are -inf; the weights are the scores' softmax over the characters.
    Returns (context (B, T, D), weights (B, T, T_in))."""
    B, T, A = q.shape
    additive_attention.energy_elements += B * T * keys.shape[1] * A
    e = (torch.tanh(q[:, :, None] + keys[:, None]) @ v)[..., 0]
    e = e.masked_fill(~mask[:, None, :], float("-inf"))
    weights = torch.softmax(e, dim=-1)
    return weights @ values, weights


additive_attention.energy_elements = 0

"""Plain SASRec (Kang & McAuley 2018) as the benchmark's configuration
states it, with its three training steps.

The model: ids are item index + 1 with 0 for a pad, a history right-aligned
in ``max_len + 1`` positions, inputs the first ``max_len`` and targets the
last. ``x = emb[id] + pos``; each block applies ``y = LN(x)`` (eps 1e-6
inside the square root, a gain, no bias), single- or multi-head causal
softmax attention of ``y W_qkv`` with scale 1/sqrt(head size),
``x += attn W_o``, ``x += relu(LN(x) W_1) W_2``, and zeroes the pad
positions. The loss is the mean, over positions whose input and target are
both items, of the cross-entropy of the target against every item's
embedding (the full softmax). Departures from the paper: no dropout and the
full softmax in place of one sampled negative.

Training is Adam (β 0.9 and 0.999, eps 1e-8) on every leaf.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import precision as _precision

LEAVES = ("wqkv", "wo", "ln1", "ln2", "w1", "w2")


def sequences(user: np.ndarray, item: np.ndarray, t: np.ndarray, n_users: int,
              length: int) -> np.ndarray:
    """(trainable users, ``length``) int64: each user's items by time (ties
    in the order given), the last ``length`` right-aligned, ids + 1, 0 for a
    pad; users with at least two events, in user order."""
    order = np.lexsort((np.arange(len(user)), t, user))
    u, it = user[order], item[order]
    counts = np.bincount(u, minlength=n_users)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    from_end = counts[u] - 1 - (np.arange(len(u)) - first[u])
    keep = from_end < length
    out = np.zeros((n_users, length), np.int64)
    out[u[keep], length - 1 - from_end[keep]] = it[keep] + 1
    return out[counts >= 2]


def _layer_norm(x, g):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g


def loss(params: dict, seq: torch.Tensor, n_heads: int, precision: str) -> torch.Tensor:
    """The mean masked next-item cross-entropy of the batch ``seq``
    (B, max_len + 1)."""
    def mm(a, b):
        return _precision.matmul(a, b, precision)

    inp, tgt = seq[:, :-1], seq[:, 1:]
    x = params["emb"][inp] + params["pos"][None]
    b, t, d = x.shape
    h = d // n_heads
    pad = (inp == 0)[..., None]
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    for layer in params["layers"]:
        y = _layer_norm(x, layer["ln1"])
        q, k, v = (z.reshape(b, t, n_heads, h).transpose(1, 2)
                   for z in mm(y, layer["wqkv"]).split(d, dim=-1))
        s = mm(q * (1.0 / math.sqrt(h)), k.transpose(-1, -2))
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        a = mm(p, v).transpose(1, 2).reshape(b, t, d)
        x = x + mm(a, layer["wo"])
        x = x + mm(torch.relu(mm(_layer_norm(x, layer["ln2"]), layer["w1"])), layer["w2"])
        x = x.masked_fill(pad, 0.0)
    logits = mm(x, params["emb"][1:].T)
    mask = (tgt != 0) & (inp != 0)
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, (tgt - 1).clamp_min(0)[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp_min(1)


def leaves(params: dict) -> dict:
    """Name → tensor, named as ``emb``, ``pos``, ``layers.<i>.<leaf>``."""
    out = {"emb": params["emb"], "pos": params["pos"]}
    for i, layer in enumerate(params["layers"]):
        out.update({f"layers.{i}.{k}": layer[k] for k in LEAVES})
    return out


def train_steps(init: dict, batches: list, n_heads: int, lr: float, precision: str,
                device) -> dict:
    """Adam steps from the host params ``init`` (``emb``, ``pos`` and a list
    of layer dicts) on each batch of ``batches`` (int64 (B, max_len + 1)
    tensors). Returns each step's loss, the first step's gradient norm a
    leaf, and each leaf's change after the last step, as float64 numbers."""
    dt = _precision.dtype(precision)

    def put(a):
        return torch.tensor(np.asarray(a), dtype=dt, device=device).requires_grad_(True)

    params = {"emb": put(init["emb"]), "pos": put(init["pos"]),
              "layers": [{k: put(layer[k]) for k in LEAVES} for layer in init["layers"]]}
    named = leaves(params)
    start = {k: p.detach().clone() for k, p in named.items()}
    m = {k: torch.zeros_like(p) for k, p in named.items()}
    v = {k: torch.zeros_like(p) for k, p in named.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, grad_norms = [], {}
    for step, seq in enumerate(batches, 1):
        value = loss(params, seq.to(device), n_heads, precision)
        grads = torch.autograd.grad(value, list(named.values()))
        losses.append(float(value.detach()))
        with torch.no_grad():
            for (k, p), g in zip(named.items(), grads):
                if step == 1:
                    grad_norms[k] = float(g.double().norm())
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** step)
                v_hat = v[k] / (1 - b2 ** step)
                p.sub_(lr * m_hat / (v_hat.sqrt() + eps))
    change = {k: float((p.detach().double() - start[k].double()).norm()) for k, p in named.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}

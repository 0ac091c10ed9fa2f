"""Plain Qwen2-MoE language model (Qwen/Qwen1.5-MoE-A2.7B): token
embedding, pre-norm blocks of causal multi-head attention with RoPE and an
MoE feed-forward (a softmax router over ``num_experts``, the top
``num_experts_per_tok`` experts a token, SwiGLU experts, and a shared
SwiGLU expert scaled by a sigmoid gate), a final RMSNorm and an untied LM
head. The router's weights are renormalised over the chosen experts, and
each expert takes at most ``capacity`` assignments of a pass, in token
order, the rest dropped, as ``bench/configs/qwen2_moe_a2_7b.json`` states.
The auxiliary loss is the Switch load-balance term of each token's first
expert.

It reads the benchmark's parameter tree and the configuration file's
sizes, and nothing of the program."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference import layers as L

#: the experts' capacity couples the rows of a pass: no blocks of rows
ROWS_INDEPENDENT = False


def capacity(conf: dict, n_tokens: int) -> int:
    """Assignments an expert takes in a pass of ``n_tokens`` tokens: all of
    them up to ``capacity_all_below`` assignments, else
    ceil(assignments * capacity_factor / experts) rounded up to 8 (and at
    least 8)."""
    a = n_tokens * conf["num_experts_per_tok"]
    if a <= conf["capacity_all_below"]:
        return a
    c = max(math.ceil(a * conf["capacity_factor"] / conf["num_experts"]), 8)
    return -(-c // 8) * 8


def routed(p: dict, x: torch.Tensor, conf: dict, num):
    """The routed experts on x (N, D): (output (N, D), aux loss)."""
    n, d = x.shape
    e, k = conf["num_experts"], conf["num_experts_per_tok"]
    probs = torch.softmax(num.mm(x, p["router"]), dim=-1)
    top_w, top_e = torch.topk(probs, k, dim=-1)
    if conf["norm_topk_prob"]:
        top_w = top_w / top_w.sum(-1, keepdim=True)
    first = F.one_hot(top_e[:, 0], e).float()
    aux = e * (first.mean(0) * probs.mean(0)).sum()
    # each assignment's place in its expert's queue, in token-major order
    flat = top_e.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    place = torch.empty_like(flat)
    place[order] = torch.arange(flat.numel(), device=x.device) - starts[flat[order]]
    cap = capacity(conf, n)
    kept = place < cap
    slot = flat * cap + place
    token = torch.arange(n, device=x.device).repeat_interleave(k)
    buf = x.new_zeros(e * cap, d).index_copy(0, slot[kept], x[token[kept]])
    buf = buf.reshape(e, cap, d)
    gate = num.ein("ecd,edf->ecf", buf, p["wg"])
    up = num.ein("ecd,edf->ecf", buf, p["wu"])
    y = num.ein("ecf,efd->ecd", F.silu(gate) * up, p["wo"]).reshape(e * cap, d)
    w = (top_w.reshape(-1) * kept)[:, None]
    picked = y[slot.clamp_max(e * cap - 1)] * w  # dropped rows weigh 0
    return picked.reshape(n, k, d).sum(1), aux


def block(p: dict, x: torch.Tensor, conf: dict, num):
    b, s, d = x.shape
    h, hd, eps = conf["num_attention_heads"], conf["head_dim"], conf["rms_norm_eps"]
    a = p["attn"]
    xn = L.rmsnorm(x, p["attn_norm"]["scale"], eps)
    q = L.rope(num.mm(xn, a["wq"]).reshape(b, s, h, hd), conf["rope_theta"])
    k = L.rope(num.mm(xn, a["wk"]).reshape(b, s, h, hd), conf["rope_theta"])
    v = num.mm(xn, a["wv"]).reshape(b, s, h, hd)
    x = x + num.mm(L.causal_attention(q, k, v, num).reshape(b, s, h * hd), a["wo"])
    xn = L.rmsnorm(x, p["mlp_norm"]["scale"], eps)
    m = p["moe"]
    out, aux = routed(m, xn.reshape(b * s, d), conf, num)
    sh = m["shared"]
    shared = L.swiglu(xn, sh["wi_gate"], sh["wi_up"], sh["wo"], num)
    gate = torch.sigmoid(num.mm(xn, m["shared_gate"]))
    return x + out.reshape(b, s, d) + gate * shared, aux


def hidden(params: dict, tokens: torch.Tensor, conf: dict, num, remat: bool = False):
    """(final normed hidden states (B, S, D), auxiliary loss averaged over
    the layers). The whole of ``tokens`` is one pass for the capacity."""
    x = params["embed"]["embedding"].float()[tokens.long()]
    stack = params["layers"]
    aux = 0.0
    for i in range(conf["num_hidden_layers"]):
        p = _layer(stack, i)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(block, p, x, conf, num,
                                                     use_reentrant=False)
        else:
            x, a = block(p, x, conf, num)
        aux = aux + a
    x = L.rmsnorm(x, params["final_norm"]["scale"], conf["rms_norm_eps"])
    return x, aux / conf["num_hidden_layers"]


def _layer(stack, i):
    if isinstance(stack, dict):
        return {k: _layer(v, i) for k, v in stack.items()}
    return stack[i]


def head(params: dict, h: torch.Tensor, num) -> torch.Tensor:
    """The logits: h times the LM head, or, where the configuration ties it,
    times the embedding table transposed."""
    emb = params["embed"]
    return num.mm(h, emb["unembed"] if "unembed" in emb else emb["embedding"].T)

"""Plain Mamba2 language model (arXiv:2405.21060; state-spaces/mamba2-370m):
token embedding, ``n_layer`` pre-norm Mamba2 blocks (input projections to
z, x, B, C and dt; depthwise causal convolutions of x and of B, C with
SiLU; the SSD scan with skip D; the gated RMSNorm of y * silu(z); the
output projection), a final RMSNorm and the LM head tied to the
embedding, as published.

It reads the benchmark's parameter tree (``bench.weights``, the layout of
``bench/configs/mamba2_370m.json``'s model) and the configuration file's
sizes, and nothing of the program."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference import layers as L

#: no term couples the rows of a batch: the reference may take them in blocks
ROWS_INDEPENDENT = True


def block(p: dict, x: torch.Tensor, conf: dict, num) -> torch.Tensor:
    eps, n, hp = conf["rms_norm_eps"], conf["d_state"], conf["headdim"]
    b, s, _ = x.shape
    xn = L.rmsnorm(x, p["norm"]["scale"], eps)
    z = num.mm(xn, p["wz"])
    xc = num.mm(xn, p["wx"])
    bc = num.mm(xn, p["wbc"])
    dt = F.softplus(num.mm(xn, p["wdt"]) + p["dt_bias"])
    xc = F.silu(L.causal_conv(xc, p["conv_x_w"], p["conv_x_b"]))
    bc = F.silu(L.causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"]))
    xs = xc.reshape(b, s, -1, hp)
    y = L.ssd(xs, dt, -torch.exp(p["A_log"]), bc[..., :n], bc[..., n:],
              conf["chunk_size"], num)
    y = (y + p["D"][:, None] * xs).reshape(b, s, -1)
    y = L.rmsnorm(y * F.silu(z), p["gate_norm"]["scale"], eps)
    return x + num.mm(y, p["wo"])


def hidden(params: dict, tokens: torch.Tensor, conf: dict, num, remat: bool = False):
    """(final normed hidden states (B, S, D), auxiliary loss 0)."""
    x = params["embed"]["embedding"].float()[tokens.long()]
    stack = params["layers"]
    for i in range(conf["n_layer"]):
        p = {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict) else v[i])
             for k, v in stack.items()}
        if remat:
            x = torch.utils.checkpoint.checkpoint(block, p, x, conf, num, use_reentrant=False)
        else:
            x = block(p, x, conf, num)
    x = L.rmsnorm(x, params["final_norm"]["scale"], conf["rms_norm_eps"])
    return x, torch.zeros((), device=x.device)


def head(params: dict, h: torch.Tensor, num) -> torch.Tensor:
    """The logits: h times the LM head, or, where the configuration ties it,
    times the embedding table transposed."""
    emb = params["embed"]
    return num.mm(h, emb["unembed"] if "unembed" in emb else emb["embedding"].T)

"""Model FLOPs: a frozen copy of ``launch/roofline.py::model_flops`` from
``src/repro_torch`` at commit cbce191 (6·N·D for training, 2·N·D for a
forward pass, N the active product parameters: the embedding lookup left
out, routed experts scaled by top-k / experts; plus the causal attention
term 4·ctx·H·hd a token a layer at the average context S/2), with the
parameter counts worked out from the configuration file's sizes instead of
the program's parameter tree. Recomputation is not counted."""
from __future__ import annotations


def param_counts(conf: dict) -> dict:
    """{"total", "embed_table", "expert"} of a configuration file."""
    fam = conf["family"]
    if fam == "ssm":
        d, v = conf["d_model"], conf["vocab_size"]
        di = conf["expand"] * d
        h, gn, w = di // conf["headdim"], 2 * conf["ngroups"] * conf["d_state"], conf["d_conv"]
        layer = d + 2 * d * di + d * gn + d * h + 3 * h + (w + 1) * (di + gn) + di + di * d
        layers, expert = conf["n_layer"], 0
    elif fam == "moe":
        d, v = conf["hidden_size"], conf["vocab_size"]
        h, kv, hd = conf["num_attention_heads"], conf["num_key_value_heads"], conf["head_dim"]
        e, f = conf["num_experts"], conf["moe_intermediate_size"]
        fs = conf["shared_expert_intermediate_size"]
        layer = (2 * d + 2 * d * h * hd + 2 * d * kv * hd + d * e + 3 * e * d * f
                 + 3 * d * fs + d)
        layers = conf["num_hidden_layers"]
        expert = layers * 3 * e * d * f
    else:
        raise ValueError(f"no parameter count for the {fam} family")
    head = 0 if conf["tie_word_embeddings"] else d * v
    return {"total": layers * layer + v * d + head + d, "embed_table": v * d,
            "expert": expert}


def model_flops(conf: dict, rows: int, seq: int, train: bool) -> float:
    """Model FLOPs of one pass of ``rows`` sequences of ``seq`` tokens."""
    counts = param_counts(conf)
    n = counts["total"]
    if not conf["tie_word_embeddings"]:
        n -= counts["embed_table"]
    if conf["family"] == "moe":
        frac = conf["num_experts_per_tok"] / conf["num_experts"]
        n = n - counts["expert"] + counts["expert"] * frac
    tokens = rows * seq
    mult = 6.0 if train else 2.0
    flops = mult * n * tokens
    if conf["family"] == "moe":
        att = (4.0 * (seq / 2) * conf["num_attention_heads"] * conf["head_dim"]
               * conf["num_hidden_layers"])
        flops += (mult / 2.0) * att * tokens
    return float(flops)

"""Serving example on the PyTorch port: batched greedy decoding with a
prefill + decode-step loop and an int8-quantized KV cache, from a (small)
randomly-initialized qwen3-family model. Counterpart of
``examples/serve_lm.py``: the same model, 4 requests of 12 prompt tokens
and 24 generated ones, a 64-position int8 cache, the prompt teacher-forced
through decode steps and greedy argmax after it.

``generate`` is the loop, on whatever device the parameters and prompts
lie on; it also returns every step's logits, and ``forced`` feeds given
tokens in place of its own argmax (teacher forcing), so the same loop can
be held against another run of it or against the reference's on converted
weights (``models.transformer.params_from_reference``). ``main`` draws the
weights with ``api.init(0, cfg, device)`` and the prompts from seed 1: the
port's init draws from the reference's distributions, not its values
(``common.fold_seed``), so the tokens printed differ from the reference
example's. The loop runs under ``torch.inference_mode()`` and updates the
cache in place, where the reference donates it to ``jax.jit``.

``--device`` defaults to ``cuda``; without a GPU the example raises unless
given ``--device cpu``.

  PYTHONPATH=src python examples/torch_serve_lm.py
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).parent.parent / "src"))

from repro_torch.config import ModelConfig
from repro_torch.models import api

CONFIG = ModelConfig(
    name="serve-demo", family="dense", num_layers=4, d_model=256,
    num_heads=8, num_kv_heads=4, d_ff=1024, vocab_size=32768,
)
BATCH, PROMPT_LEN, GEN_LEN, MAX_LEN = 4, 12, 24, 64
KV_DTYPE = "int8"


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, forced=None):
    """Greedy decode of ``prompts`` (B, P) int32 into a ``MAX_LEN`` cache of
    ``KV_DTYPE``: the prompt teacher-forced through decode steps, then
    ``GEN_LEN`` argmax tokens. ``forced`` (B, GEN_LEN), when given, is fed
    after the prompt in place of the argmax. Returns (the argmax tokens (B,
    GEN_LEN), every step's last-position logits (P + GEN_LEN - 1, B, V))."""
    batch, prompt_len = prompts.shape
    cache = api.init_cache(cfg, batch, MAX_LEN, kv_dtype=KV_DTYPE, device=prompts.device)
    tok = prompts[:, :1]
    generated, steps = [], []
    with torch.inference_mode():
        for t in range(prompt_len + GEN_LEN - 1):
            logits, cache = api.decode_step(params, cache, tok, t, cfg)
            steps.append(logits[:, -1])
            if t + 1 < prompt_len:
                tok = prompts[:, t + 1:t + 2]  # teacher-forced prefill
            else:
                tok = torch.argmax(logits[:, -1:], dim=-1).to(prompts.dtype)
                generated.append(tok)
                if forced is not None:
                    i = len(generated)
                    tok = forced[:, i - 1:i]
    return torch.cat(generated, dim=1), torch.stack(steps)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, and this host has no GPU")

    cfg = CONFIG
    params = api.init(0, cfg, args.device)
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=gen,
                            dtype=torch.int32).to(args.device)
    t0 = time.monotonic()
    out, _ = generate(params, cfg, prompts)
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)
    dt = time.monotonic() - t0
    print(f"generated {tuple(out.shape)} tokens for {BATCH} requests in {dt:.2f}s "
          f"({BATCH * GEN_LEN / dt:.1f} tok/s, int8 KV cache)")
    print(out)
    return out


if __name__ == "__main__":
    main()

"""The benchmark's cells at the sizes of the port's SMOKE configurations,
for the CPU tests: the same files with the sizes cut, the port on the CPU
(its kernels' plain versions)."""
from __future__ import annotations

import json
import time
from pathlib import Path

from bench import harness

ROOT = Path(__file__).resolve().parents[2]

#: configuration file -> the keys cut for the CPU and the port's overrides to match
SMOKE = {
    "mamba2_370m": ({"d_model": 64, "n_layer": 2, "vocab_size": 512, "d_state": 16,
                     "headdim": 16, "chunk_size": 16},
                    {"num_layers": 2, "d_model": 64, "vocab_size": 512, "ssm_state": 16,
                     "ssm_head_dim": 16, "ssm_chunk": 16}),
    "qwen2_moe_a2_7b": ({"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
                         "num_key_value_heads": 4, "head_dim": 16, "moe_intermediate_size": 48,
                         "shared_expert_intermediate_size": 96, "num_experts": 6,
                         "num_experts_per_tok": 4, "vocab_size": 512},
                        {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
                         "head_dim": 16, "d_ff": 48, "moe_d_ff": 48, "vocab_size": 512,
                         "num_experts": 6, "num_experts_per_tok": 4, "num_shared_experts": 2}),
}
#: mix parameters cut for the CPU; the qwen2-moe prefill's pass of one
#: 2176-token prompt routes more than 8192 assignments, so the experts'
#: capacity drops some (``test_bench_reference`` holds that path in the
#: forward too)
MIX = {"train": {"seq_len": 256, "pool_rows": 16},
       "prefill": {"lengths": [64, 160, 2176], "median_tokens": 160, "requests_per_cycle": 8,
                   "pool_rows": 16, "sample_batches": 3}}
CELL = {"mamba2_370m.train_4k": {"batch": 2, "ref_rows": 1},
        "qwen2_moe_a2_7b.train_4k": {"batch": 4},
        "qwen2_moe_a2_7b.prefill_mixed": {"batch_tokens": 8704}}


def smoke_conf(name: str, tmp: Path) -> Path:
    conf = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    sizes, port = SMOKE[name]
    conf.update(sizes)
    conf["port_overrides"] = dict(conf["port_overrides"], **port)
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(conf))
    return path


def run(cell_name: str, tmp: Path, *, seed: int = 7, seconds: float = 0.0) -> dict:
    spec = harness.load_spec(ROOT)
    cell = harness.find_cell(spec, cell_name)
    kind = json.loads((ROOT / "bench" / "traffic" / f"{cell['traffic']}.json")
                      .read_text())["kind"]
    return harness.run_cell(spec, cell, seed=seed, seconds=seconds, trace=False,
                            t_start=time.perf_counter(), device="cpu",
                            conf_file=smoke_conf(cell["config"], tmp),
                            mix_override=dict(MIX[kind], **CELL[cell_name]))

"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, against the
reference's (``repro.launch.dryrun``) and against real runs of the same
steps:

* the calibration algebra: the reference's ``reconstruct``, run in a
  subprocess (its import pins JAX to 512 host devices) with its
  ``_measure`` replaced by a synthetic affine measure, and the port's with
  the same measure give bitwise the same totals (dense at k = 1 and 2, the
  hybrid's 6-point system);
* the port's ``reconstruct`` over real calibration traces equals its full
  trace (a trace runs every layer) for the dense and hybrid SMOKE train
  steps at 2 microbatches, within 1e-9 relative (the hybrid's bytes at
  whole groups of its shared-attention period; with a tail layer, 5e-3);
* the kernels' custom ops: under ``FakeTensorMode`` on fake CUDA tensors
  ``ops.flash_attention``, ``ops.ssd_scan``, ``ops.gmm`` and the backwards
  of the first two give the kernels' output shapes, dtypes and strides and
  launch nothing; each FLOP formula equals ``FlopCounterMode`` on the plain
  version (the plain backward for a backward's) at 3 shapes;
* world 1: every family's SMOKE step in each mode its config takes traces
  to the FLOPs, bytes and memory that the same counter reads on the real
  CPU step;
* the 80 (arch, shape, mesh) records' statuses are the reference's
  ``applicable_shapes``, and the reference's unedited
  ``scripts/collect_results.py`` renders a record the port wrote.

The trace of the sharded step against the real 8-rank gloo world is in
tests/test_torch_sharded.py, which runs that world.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.config import SHAPES as RSHAPES  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.config import SHAPES, RunConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import gmm as kgmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import moe as moe_model  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.train.optim import make_optimizer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RECON_TOL = 1e-9
SMOKE_B, SMOKE_S = 4, 16
# every family's config, by the arch whose SMOKE config stands for it
FAMILIES = {"dense": "qwen3_1_7b", "vlm": "pixtral_12b", "audio": "hubert_xlarge",
            "moe": "qwen2_moe_a2_7b", "ssm": "mamba2_370m", "hybrid": "zamba2_7b"}
# (arch, shape, microbatches) of the algebra's cells
ALGEBRA = [("qwen3_1_7b", "prefill_32k", 1), ("qwen3_1_7b", "train_4k", 1),
           ("qwen3_1_7b", "train_4k", 2), ("zamba2_7b", "train_4k", 2),
           ("zamba2_7b", "decode_32k", 1)]


def synthetic_measure(run, pc, want_mem=False, device=None):
    """A measurement affine in (L, k, L·k) and, for a hybrid, in the
    shared-attention layers, with non-round coefficients."""
    cfg = run.model
    L, k = cfg.num_layers, run.train.microbatches
    n_a = L // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    flops = 1.7e9 + 3.3e7 * k + 9.1e8 * L + 2.9e7 * k * L + 4.3e8 * n_a + 1.1e7 * k * n_a
    nbytes = 2.3e8 + 5.9e6 * k + 7.7e7 * L + 3.1e6 * k * L + 5.3e7 * n_a + 1.3e6 * k * n_a
    wire = {"all-gather": 1.9e7 * L * k + 3.7e6 * n_a, "all-reduce": 2.1e6 + 1.3e5 * k}
    return {"flops": flops, "bytes": nbytes, "coll_wire": wire, "coll_counts": {},
            "coll_result": {}, "lower_s": 0.0, "compile_s": 0.0}


_REFERENCE_ALGEBRA = """
import json, sys
sys.path.insert(0, {tests!r})
from repro import configs
from repro.launch import dryrun
from test_torch_dryrun import ALGEBRA, synthetic_measure
dryrun._measure = synthetic_measure
out = []
for arch, shape, k in ALGEBRA:
    run = configs.make_run(arch, shape, train_microbatches=k)
    out.append(dryrun.reconstruct(run, None, verbose=False))
print(json.dumps(out))
"""


def test_reconstruct_is_the_references_algebra(monkeypatch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c",
                          _REFERENCE_ALGEBRA.format(tests=str(ROOT / "tests"))],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.splitlines()[-1])
    monkeypatch.setattr(dryrun, "_measure", synthetic_measure)
    got = [dryrun.reconstruct(configs.make_run(arch, shape, train_microbatches=k), None,
                              verbose=False) for arch, shape, k in ALGEBRA]
    # JSON keeps a float's every bit
    assert json.loads(json.dumps(got)) == want


def smoke_run(arch: str, mode: str, microbatches: int = 1) -> RunConfig:
    cfg = configs.smoke(arch).scaled(compute_dtype="float32")
    return RunConfig(model=cfg, shape=ShapeConfig(mode, SMOKE_S, SMOKE_B, mode),
                     train=TrainConfig(total_steps=10, warmup_steps=1,
                                       microbatches=microbatches))


# (family, layers (None: the SMOKE config's), bytes limit): the hybrid at
# whole groups of its shared-attention period and at its SMOKE config's 5
# layers, 2 groups of 2 and a tail layer, which the reference's 6-point
# system takes for a group layer (its stacked parameters' gradients move
# other bytes); the FLOPs are exact in every case
RECONSTRUCTED = [("dense", None, RECON_TOL), ("hybrid", 4, RECON_TOL),
                 ("hybrid", None, 5e-3)]


@pytest.mark.parametrize("family,layers,bytes_tol", RECONSTRUCTED)
def test_reconstruction_equals_the_full_trace(family, layers, bytes_tol):
    run = smoke_run(FAMILIES[family], "train", microbatches=2)
    if layers is not None:
        run = run.replace(model=run.model.scaled(num_layers=layers))
    full = dryrun._measure(run, None, device="cpu")
    rec = dryrun.reconstruct(run, None, verbose=False, device="cpu")
    assert full["flops"] > 0 and full["bytes"] > 0
    assert abs(rec["flops"] - full["flops"]) <= RECON_TOL * full["flops"]
    assert abs(rec["bytes accessed"] - full["bytes"]) <= bytes_tol * full["bytes"]
    assert rec["wire_bytes"] == {} == full["coll_wire"]


def _kernel_cases():
    """(name, the op's call on given tensors, the plain version's, its
    inputs' shapes and dtypes) at shapes that need no copy on the card."""
    bf, f32 = torch.bfloat16, torch.float32
    return [
        ("flash_attention", lambda q, k, v: ops.flash_attention(q, k, v),
         lambda q, k, v: ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                                 v.transpose(1, 2)).transpose(1, 2),
         [((2, 40, 4, 64), bf), ((2, 40, 2, 64), bf), ((2, 40, 2, 64), bf)]),
        ("ssd_scan", lambda x, dt, a, b, c: ops.ssd_scan(x, dt, a, b, c, chunk=16),
         lambda x, dt, a, b, c: ref.ssd_chunked(x, dt, a, b, c, 16),
         [((2, 48, 4, 16), f32), ((2, 48, 4), f32), ((4,), f32), ((2, 48, 1, 8), f32),
          ((2, 48, 1, 8), f32)]),
        ("gmm", lambda x, w: ops.gmm(x, w), ref.gmm_ref,
         [((3, 5, 16), bf), ((3, 16, 24), bf)]),
        # the backwards, in and out in the model's (B, S, heads, hd) layout
        ("flash_attention_bwd",
         lambda q, k, v, o, lse, do: tuple(t.transpose(1, 2) for t in kfa.launch_bwd(
             *(t.transpose(1, 2) for t in (q, k, v, o)), lse, do.transpose(1, 2), causal=True)),
         lambda q, k, v, o, lse, do: tuple(t.transpose(1, 2) for t in ref.flash_attention_bwd(
             *(t.transpose(1, 2) for t in (q, k, v, o, do)), causal=True)),
         [((2, 40, 4, 64), bf), ((2, 40, 2, 64), bf), ((2, 40, 2, 64), bf), ((2, 40, 4, 64), bf),
          ((2, 4, 40), f32), ((2, 40, 4, 64), bf)]),
        ("ssd_scan_bwd",
         lambda x, dt, a, b, c, dy, st: kssd.launch_bwd(x, dt, a, b, c, dy, st, chunk=16),
         lambda x, dt, a, b, c, dy, st: ref.ssd_chunked_bwd(x, dt, a, b, c, dy, st, 16),
         [((2, 48, 4, 16), f32), ((2, 48, 4), f32), ((4,), f32), ((2, 48, 1, 8), f32),
          ((2, 48, 1, 8), f32), ((2, 48, 4, 16), f32), ((2, 4, 16, 8), f32)]),
    ]


@pytest.mark.parametrize("case", _kernel_cases(), ids=lambda c: c[0])
def test_fake_implementations_give_the_kernels_outputs_and_launch_nothing(case):
    """On fake CUDA tensors each wrapper runs its op's fake implementation:
    the plain version's shapes and dtypes, the kernel's layout (contiguous),
    and no launch."""
    name, call, plain, specs = case
    mods = (kfa, kssd, kgmm)
    before = [m.LAUNCHES for m in mods]
    gen = torch.Generator().manual_seed(0)
    want = plain(*(torch.randn(s, generator=gen).to(d) for s, d in specs))
    with FakeTensorMode(), torch.no_grad():
        got = call(*(torch.empty(s, dtype=d, device="cuda") for s, d in specs))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [m.LAUNCHES for m in mods] == before
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cuda"
        assert g.shape == w.shape and g.dtype == w.dtype
        # new contiguous tensors (K2's in the model's (B, S, H, hd) layout)
        assert g.is_contiguous()


class _BytesByOp(dryrun.StepCounter):
    """The counter's bytes, split by op."""

    def __init__(self):
        super().__init__()
        self.by_op: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.bytes
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self.bytes != before:
            name = str(func)
            self.by_op[name] = self.by_op.get(name, 0) + self.bytes - before
        return out


@pytest.mark.parametrize("d_stride", [None, 68])
def test_traced_moe_backward_counts_no_operand_copy(d_stride):
    """The MoE layer's expert products (``moe.expert_ffn``, bf16) traced
    forward and backward on meta tensors, the path of a shape-only trace:
    K4's backward launches read the transposed views as they lie, so the
    counter sees no copy, and the bytes it counts for the kernel's op are
    each of the nine launches' operands read once and its output written
    once. The control, a wo (E, F, D) whose row stride (68 for 64 columns)
    no TMA map takes, counts the copies the card makes of it."""
    e, c, d, f = 4, 40, 64, 48
    cfg = configs.smoke("qwen2_moe_a2_7b").scaled(compute_dtype="bfloat16")
    bf = torch.bfloat16
    buf = torch.empty((e, c, d), dtype=bf, device="meta", requires_grad=True)
    wg, wu = (torch.empty((e, d, f), dtype=bf, device="meta", requires_grad=True)
              for _ in range(2))
    wo = torch.empty((e, f, d_stride or d), dtype=bf, device="meta")[..., :d]
    wo.requires_grad_(True)
    with _BytesByOp() as counter:
        y = moe_model.expert_ffn(buf, wg, wu, wo, cfg)
        grads = torch.autograd.grad(y, (buf, wg, wu, wo), torch.empty_like(y))
    assert [g.shape for g in grads] == [t.shape for t in (buf, wg, wu, wo)]
    copies = sum(b for op, b in counter.by_op.items() if "copy" in op or "zero" in op)
    # three products forward, and dx and dw of each: every launch reads an
    # (E, C, D)-sized, a (D, F)-sized and writes a (C, F)-sized operand
    want = 2 * 9 * (e * c * d + e * d * f + e * c * f)
    if d_stride is None:
        assert copies == 0, counter.by_op
        assert counter.by_op["repro_torch.gmm.default"] == want
    else:
        assert copies > 0, counter.by_op


FORMULA_SHAPES = {
    "flash_attention": [(1, 2, 1, 8, 8, 16), (2, 4, 2, 40, 33, 32), (1, 8, 8, 17, 64, 16)],
    "ssd_scan": [(1, 16, 2, 8, 1, 4, 16), (2, 40, 4, 16, 2, 8, 16), (1, 33, 2, 8, 1, 8, 64)],
    "gmm": [(1, 1, 1, 1), (3, 5, 7, 6), (4, 33, 16, 9)],
    "flash_attention_bwd": [(1, 2, 1, 8, 8, 16), (2, 4, 2, 40, 33, 32), (1, 8, 8, 17, 64, 16)],
    "ssd_scan_bwd": [(1, 16, 2, 8, 1, 4, 16), (2, 40, 4, 16, 2, 8, 16), (1, 33, 2, 8, 1, 8, 64)],
}


def _flop_count(fn) -> int:
    with FlopCounterMode(display=False) as m:
        fn()
    return m.get_total_flops()


@pytest.mark.parametrize("name", list(FORMULA_SHAPES))
def test_flop_formulas_count_what_the_plain_versions_count(name):
    gen = torch.Generator().manual_seed(1)
    for shape in FORMULA_SHAPES[name]:
        if name == "flash_attention":
            b, h, kv, sq, skv, hd = shape
            q, k = torch.randn(b, h, sq, hd, generator=gen), torch.randn(b, kv, skv, hd,
                                                                         generator=gen)
            want = _flop_count(lambda: ref.flash_attention_ref(q, k, k))
            got = kfa.flops.__wrapped__(q.shape, k.shape, k.shape, True)
        elif name == "ssd_scan":
            b, s, h, p, g, n, chunk = shape
            x, dt = torch.randn(b, s, h, p, generator=gen), torch.rand(b, s, h, generator=gen)
            A, B = -torch.rand(h, generator=gen), torch.randn(b, s, g, n, generator=gen)
            want = _flop_count(lambda: ref.ssd_chunked(x, dt, A, B, B, chunk))
            got = kssd.flops.__wrapped__(x.shape, dt.shape, A.shape, B.shape, B.shape, chunk)
        elif name == "flash_attention_bwd":
            b, h, kv, sq, skv, hd = shape
            q, k = torch.randn(b, h, sq, hd, generator=gen), torch.randn(b, kv, skv, hd,
                                                                         generator=gen)
            want = _flop_count(lambda: ref.flash_attention_bwd(q, k, k, q, q, causal=True))
            got = kfa.bwd_flops.__wrapped__(q.shape, k.shape, k.shape, q.shape, (b, h, sq),
                                            q.shape, True)
        elif name == "ssd_scan_bwd":
            b, s, h, p, g, n, chunk = shape
            x, dt = torch.randn(b, s, h, p, generator=gen), torch.rand(b, s, h, generator=gen)
            A, B = -torch.rand(h, generator=gen), torch.randn(b, s, g, n, generator=gen)
            want = _flop_count(lambda: ref.ssd_chunked_bwd(x, dt, A, B, B, x, None, chunk))
            got = kssd.bwd_flops.__wrapped__(x.shape, dt.shape, A.shape, B.shape, B.shape,
                                             x.shape, None, chunk)
        else:
            e, c, d, f = shape
            x, w = torch.randn(e, c, d, generator=gen), torch.randn(e, d, f, generator=gen)
            want = _flop_count(lambda: ref.gmm_ref(x, w))
            got = kgmm.flops.__wrapped__(x.shape, w.shape, d, f)
        assert want > 0 and got == want, (shape, got, want)


def test_counter_reads_each_collective_by_the_ring_model():
    """Each collective a sharded step issues (the functional ones, and
    DTensor's all-to-all on a mesh whose backend has one, as on the card)
    is one count of its HLO kind, its local result bytes and
    ``roofline.wire_bytes`` of them over its group's size."""
    import torch.distributed._functional_collectives as fc

    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_mesh

    with dryrun.fake_world(8):
        group = make_mesh((2, 4), ("data", "model"), device="cpu").get_group("model")
        calls = {"all-reduce": lambda x: fc.all_reduce(x, "sum", group),
                 "all-gather": lambda x: fc.all_gather_tensor(x, 0, group),
                 "reduce-scatter": lambda x: fc.reduce_scatter_tensor(x, "sum", 0, group),
                 "all-to-all": lambda x: torch.ops._dtensor.shard_dim_alltoall(
                     x, 0, 1, group.group_name)}
        for kind, call in calls.items():
            with FakeTensorMode():
                counter = dryrun.StepCounter()
                with counter:
                    out = call(torch.empty(8, 16)) * 1
            b = out.numel() * out.element_size()
            assert counter.coll_counts == {kind: 1}, kind
            assert counter.coll_result == {kind: b}, kind
            assert counter.coll_wire == {kind: roofline.wire_bytes(kind, b, 4)}, kind


def _modes(arch: str) -> list[str]:
    """The modes the arch's config takes (``applicable_shapes``)."""
    ok = {SHAPES[name].mode for name, status in
          configs.applicable_shapes(configs.get(arch)).items() if status == "ok"}
    return [m for m in ("train", "prefill", "decode") if m in ok]


def _real_step(run: RunConfig) -> dryrun.StepCounter:
    """The counter on the real CPU step of ``run`` (zero tokens, the init's
    parameters)."""
    cfg, shape = run.model, run.shape
    params = api.init(0, cfg, device="cpu")
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in steps.input_specs(cfg, shape).items()}
    if shape.mode == "train":
        step = steps.make_train_step(run)[0]
        args = ({"params": params, "opt": make_optimizer(run.train).init(params)}, batch)
    elif shape.mode == "prefill":
        step, args = steps.make_prefill_step(run)[0], (params, batch)
    else:
        step = steps.make_decode_step(run)[0]
        cache = api.init_cache(cfg, shape.global_batch, shape.seq_len, run.serve.kv_dtype,
                               device="cpu")
        args = (params, cache, batch["tokens"], shape.seq_len - 1)
    counter = dryrun.StepCounter()
    counter.arguments(args)
    with counter:
        out = step(*args)
    counter.outputs(out)
    return counter


@pytest.mark.parametrize("family,mode", [(f, m) for f, arch in FAMILIES.items()
                                         for m in _modes(arch)])
def test_world_one_trace_reads_what_the_real_step_does(family, mode):
    run = smoke_run(FAMILIES[family], mode)
    got = dryrun._measure(run, None, want_mem=True, device="cpu")
    real = _real_step(run)
    assert got["flops"] > 0
    assert got["flops"] == real.flops and got["bytes"] == real.bytes
    assert got["memory_analysis"] == real.memory_analysis()
    assert got["coll_counts"] == {} == real.coll_counts


def test_every_records_status_is_the_references(monkeypatch, tmp_path):
    """``main --all --both-meshes`` writes the reference's 80 file names,
    each with the reference's status; the ok cells' traces are stood in for
    by the synthetic measure (the ok cells trace in PERF.md's run)."""
    monkeypatch.setattr(dryrun, "_measure", lambda run, pc, want_mem=False, device=None: dict(
        synthetic_measure(run, pc), memory_analysis={"argument_size_in_bytes": 1}))
    dryrun.main(["--all", "--both-meshes", "--out", str(tmp_path), "--device", "cpu"])
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert len(names) == 80 == len(rconfigs.ARCHS) * len(RSHAPES) * 2
    for arch in rconfigs.ARCHS:
        want = rconfigs.applicable_shapes(rconfigs.get(arch))
        for shape in RSHAPES:
            for mesh in ("single", "multi"):
                rec = json.loads((tmp_path / f"{arch}_{shape}_{mesh}.json").read_text())
                assert rec["status"] == want[shape], (arch, shape, mesh)
                assert ("roofline" in rec) == (want[shape] == "ok" and mesh == "single")


def test_collect_results_renders_a_record_the_port_wrote(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2_370m",
           "--shape", "decode_32k", "--device", "cpu", "--no-calibrate", "--out",
           str(tmp_path)]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads((tmp_path / "mamba2_370m_decode_32k_single.json").read_text())
    assert rec["status"] == "ok" and rec["roofline"]["useful_flops_ratio"] <= 1.05
    assert np.isclose(rec["cost_analysis"]["flops"], rec["raw_cost"]["flops"], rtol=0)
    # the port's table script with jax and the reference blocked, and the
    # reference's script, on the same record
    blocked = ("import runpy, sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
               "sys.argv = sys.argv[1:]; runpy.run_path(sys.argv[0], run_name='__main__')")
    tables = {}
    for name, cmd in (("port", [sys.executable, "-c", blocked,
                                "scripts/torch_collect_results.py"]),
                      ("ref", [sys.executable, "scripts/collect_results.py"])):
        table = subprocess.run(cmd + ["--dir", str(tmp_path)], cwd=ROOT, env=env,
                               capture_output=True, text=True, timeout=120)
        assert table.returncode == 0, table.stderr
        tables[name] = table.stdout.splitlines()
    port, ref = tables["port"], tables["ref"]
    rows = [line for line in port if line.startswith("| mamba2_370m | decode_32k |")]
    assert len(rows) == 2, port  # the dry-run table and the roofline table
    assert rows[0].startswith("| mamba2_370m | decode_32k | 16x16 | ok |")
    # every cell of every line is the reference's but the first table's
    # seventh column: "trace s" (the record's lower_s) for "compile s"
    assert len(port) == len(ref)
    first_table = port.index("### §Roofline (single-pod, loop-calibrated)")
    for i, (got, want) in enumerate(zip(port, ref)):
        if i < first_table and got.startswith("| ") and not got.startswith("|---"):
            got, want = got.split(" | "), want.split(" | ")
            assert (got[6], want[6]) in (("trace s", "compile s"),
                                         (f"{rec['lower_s']:.0f}", "0"))
            got[6] = want[6]
        assert got == want

"""The yardstick's arithmetic against hand counts: the kernels' least
times, the K4 count over routed assignments (not capacity buckets), the
model FLOPs and parameter counts, and the metric readers over a made-up
record."""
import json
from types import SimpleNamespace

import pytest
import torch

from bench import harness
from bench.tests import smoke
from bench.yardstick import bounds, flops
from bench.yardstick.peaks import HBM_BYTES_PER_S, PEAK_FLOP_PER_S

BF16 = PEAK_FLOP_PER_S[torch.bfloat16]


def _ms(nbytes, ops):
    return (nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16 * 1e3)


def test_ssd_bounds_by_hand():
    # b1 s4 h1 p2 g1 n2, chunks of 2: bytes 2*(16 + 16) + 4*(4 + 1 + 4);
    # each chunk 2*(n+p)*3 pairs + 4*p*n*2 positions = 24 + 32
    assert bounds.ssd_bound_parts_ms(1, 4, 1, 2, 1, 2, 2, torch.bfloat16) == \
        pytest.approx(_ms(100, 112))
    # backward: bytes 2*(3*8 + 4*8) + 4*(2*4 + 2); chunk 2*(3n+2p)*3 + 12*p*n*2
    assert bounds.ssd_bwd_bound_parts_ms(1, 4, 1, 2, 1, 2, 2, torch.bfloat16) == \
        pytest.approx(_ms(152, 2 * (60 + 96)))


def test_gmm_counts_routed_assignments():
    # 1000 assignments, 2 experts of (4, 8): x rows, both weights, y rows
    assert bounds.gmm_routed_parts_ms(1000, 2, 4, 8, torch.bfloat16) == \
        pytest.approx(_ms(2 * (4000 + 64 + 8000), 2 * 1000 * 4 * 8))


def _conf(name):
    return json.loads((smoke.ROOT / "bench" / "configs" / f"{name}.json").read_text())


def _run(conf, kind, passes, **trace):
    t = SimpleNamespace(**{"kernel_ns": {"k1": 0, "k2": 0, "k3": 0, "k4": 0},
                           "range_ns": {"optimizer.step": 0}, **trace})
    return SimpleNamespace(kind=kind, conf=conf, passes=passes, trace=t, window_s=2.0,
                           steps=len(passes), tokens=sum(r * s for r, s, _ in passes))


def test_k4_roofline_reads_routed_work_over_k4_time():
    conf = _conf("qwen2_moe_a2_7b")
    read, phase = harness.reader("k4_roofline.prefill")
    run = _run(conf, "prefill", [(16, 1024, False)], kernel_ns={"k1": 0, "k2": 0, "k3": 0,
                                                                 "k4": 10**7})
    a = 16 * 1024 * 4  # tokens x top-4, whatever the buckets hold
    one = max(bounds.gmm_routed_parts_ms(a, 60, 2048, 1408, torch.bfloat16))
    assert read(run, phase) == pytest.approx(100 * 3 * 4 * one * 1e6 / 1e7)
    train = _run(conf, "train", [(1, 4096, True)] * 4,
                 kernel_ns={"k1": 0, "k2": 0, "k3": 0, "k4": 10**8})
    one = max(bounds.gmm_routed_parts_ms(4096 * 4, 60, 2048, 1408, torch.bfloat16))
    read, phase = harness.reader("k4_roofline.train")
    assert read(train, phase) == pytest.approx(100 * 4 * 9 * 4 * one * 1e6 / 1e8)
    assert read(run, phase) is None  # a prefill run has no training K4 share


def test_k3_roofline_counts_forward_and_backward():
    conf = _conf("mamba2_370m")
    args = (32, 64, 1, 128, 256, torch.bfloat16)
    run = _run(conf, "train", [(8, 4096, True)], kernel_ns={"k1": 0, "k2": 0, "k3": 10**9,
                                                            "k4": 0})
    want = 48 * (max(bounds.ssd_bound_parts_ms(8, 4096, *args))
                 + max(bounds.ssd_bwd_bound_parts_ms(8, 4096, *args)))
    read, phase = harness.reader("k3_roofline.train")
    assert read(run, phase) == pytest.approx(100 * want * 1e6 / 1e9)


def test_param_counts_are_the_programs():
    from bench import program
    from repro_torch.launch.roofline import count_params

    for name in ("mamba2_370m", "qwen2_moe_a2_7b"):
        conf = _conf(name)
        assert flops.param_counts(conf) == count_params(program.model_config(conf))


def test_model_flops_and_mfu_by_hand():
    conf = _conf("qwen2_moe_a2_7b")
    c = flops.param_counts(conf)
    n = c["total"] - c["embed_table"] - c["expert"] + c["expert"] * 4 / 60
    att = 4 * 512 * 16 * 128 * 4  # ctx S/2 = 512, 16 heads of 128, 4 layers
    assert flops.model_flops(conf, 2, 1024, True) == pytest.approx(6 * n * 2048 + 3 * att * 2048)
    assert flops.model_flops(conf, 2, 1024, False) == pytest.approx(2 * n * 2048 + att * 2048)
    m = _conf("mamba2_370m")
    assert m["tie_word_embeddings"]  # the table is the head's product: counted once
    nm = flops.param_counts(m)["total"]
    assert flops.model_flops(m, 8, 4096, True) == pytest.approx(6 * nm * 8 * 4096)
    read, phase = harness.reader("mfu.train")
    run = _run(m, "train", [(8, 4096, True)] * 3, busy_ns=1.5e9)
    assert read(run, phase) == pytest.approx(100 * 3 * 6 * nm * 8 * 4096 / (1.5 * BF16))
    assert read(_run(m, "train", [(8, 4096, True)], busy_ns=0), phase) is None


def test_idle_and_torch_share_from_the_trace():
    run = _run(_conf("mamba2_370m"), "train", [(8, 4096, True)],
               kernel_ns={"k1": 0, "k2": 0, "k3": 300, "k4": 0},
               range_ns={"optimizer.step": 100}, device_ns=1000, busy_ns=900, window_ns=1200)
    read, phase = harness.reader("device_idle.train")
    assert read(run, phase) == pytest.approx(25.0)
    read, phase = harness.reader("torch_ops_share.train")
    assert read(run, phase) == pytest.approx(60.0)
    read, phase = harness.reader("optimizer_ms.train")
    assert read(run, phase) == pytest.approx(100 / 1e6)
    read, phase = harness.reader("k3_roofline.prefill")
    assert read(run, phase) is None

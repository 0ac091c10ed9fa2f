"""What the benchmark takes from the system under test, ``repro_torch``:
its model configuration, its parameter layout, its training and prefill
steps, and its kernels' launch counters. Nothing else of the harness
imports the program, and the reference imports none of it."""
from __future__ import annotations

import dataclasses

from repro_torch import configs
from repro_torch.config import RunConfig, ShapeConfig
from repro_torch.kernels import flash_attention, gmm, ibn_conv, ssd_scan
from repro_torch.train import steps
from repro_torch.train.optim import make_optimizer

#: the launch counters by kernel (K1-K4)
KERNELS = {"ibn_pointwise": ibn_conv, "flash_attention": flash_attention,
           "ssd_scan": ssd_scan, "gmm": gmm}


def model_config(conf: dict):
    """The port's ModelConfig of a configuration file: the arch it names,
    with the file's ``port_overrides``; every key of ``port_fields`` must
    read in the port as the file states it."""
    cfg = configs.get(conf["port_arch"]).scaled(**conf.get("port_overrides", {}))
    for key, field in conf["port_fields"].items():
        got = getattr(cfg, field)
        if got != conf[key]:
            raise ValueError(f"{conf['name']}: the port runs {field}={got!r}, "
                             f"the file states {key}={conf[key]!r}")
    return cfg


def param_layout(cfg):
    """The parameter tree as meta tensors (shapes and dtypes only)."""
    return steps.abstract_params(cfg)


def train_run(conf: dict, cfg, run_shape: str, batch: int, seq: int, optimizer: dict):
    """The RunConfig of a training cell: ``configs.make_run``'s settings for
    ``run_shape`` (remat, microbatches), the cell's batch, and the mix's
    optimizer settings."""
    run = configs.make_run(conf["port_arch"], run_shape)
    return run.replace(model=cfg, shape=ShapeConfig(run_shape, seq, batch, "train"),
                       train=dataclasses.replace(run.train, **optimizer))


def train_step(run: RunConfig):
    """(step(state, batch) -> (state, metrics), the optimizer's init)."""
    return steps.make_train_step(run)[0], make_optimizer(run.train).init


def prefill_step(cfg, batch: int, seq: int):
    run = RunConfig(model=cfg, shape=ShapeConfig("prefill", seq, batch, "prefill"))
    return steps.make_prefill_step(run)[0]


def first_moments(state) -> dict:
    """AdamW's first moments from the training state."""
    return state["opt"]["mu"]


def launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in KERNELS.items()}

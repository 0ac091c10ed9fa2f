"""The latency/area(/energy) cost model (paper Sec. 3.5.2, Fig. 6, Table 2).

A 3-layer MLP (hidden 256, ReLU, dropout 0.1) over the one-hot features of the
joint (α, h) configuration, with heads sharing the trunk ("the area
predictor and latency predictor largely share parameters with only separate
parameterization in the prediction heads"):

    Loss = MSE(area) + λ · MSE(latency) [+ λ_e · MSE(energy)],  λ = 10  (Eq. 7)

The energy head is optional (train with ``energy_mj=`` labels, same
log-standardize treatment as the other targets) and is what lets
energy-target scenarios (Sec. 3.4) run on the learned path instead of the
full simulator. Training data is labelled by the analytical simulator
("labelled data for accelerator performance is much cheaper than labelled
data for NAS accuracy"). Targets are log-transformed + standardized
internally; reported metrics are relative errors in the original units.

A trained ``CostModel`` satisfies the learned-backend predictor protocol
(``predict(feats (N,F)) -> (latency_ms (N,), area_mm2 (N,))``, plus
``predict_all`` when the energy head exists), so it drops into the search
via ``repro_torch.hw.LearnedBackend`` and the engine then skips the cycle
model entirely (Sec. 3.5.2's "cost model in the loop").

Counterpart of ``repro/core/costmodel.py``. ``CostModelConfig`` and
``generate_dataset`` (numpy over the port's simulator) are copies, bitwise
the reference's. The MLP, its loss and its hand-written Adam are torch and
run on ``device`` (the card unless the caller asks for the CPU):

* ``init_mlp`` draws the reference's shapes and distributions from an
  explicit CPU ``torch.Generator`` and then moves them, so one seed gives
  the same parameters on the card and on the CPU. It does not reproduce
  ``jax.random``; ``params_from_reference`` converts the reference's
  parameters instead.
* ``train`` draws its batch indices from the reference's numpy sampler
  (``default_rng(seed + 1)``), so they are bitwise the reference's, and its
  dropout masks from a generator on ``device``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.common import tree_from_numpy, tree_leaves, tree_unflatten
from repro_torch.core import simulator
from repro_torch.core.space import Space


@dataclasses.dataclass
class CostModelConfig:
    hidden: int = 256
    layers: int = 3
    dropout: float = 0.1
    lr: float = 1e-3
    batch: int = 128
    steps: int = 20_000
    lam: float = 10.0  # Eq. 7 λ
    lam_energy: float = 10.0  # energy-head weight (performance-class metric)
    seed: int = 0


def _dense(gen, fan_in: int, fan_out: int, std: float, device) -> dict:
    w = torch.randn((fan_in, fan_out), generator=gen) * std
    return {"w": w.to(device), "b": torch.zeros((fan_out,), device=device)}


def init_mlp(gen: torch.Generator, in_dim: int, cfg: CostModelConfig,
             energy: bool = False, device="cuda") -> dict:
    """He-normal trunk, N(0, 0.01²) heads, zero biases (the reference's
    shapes and distributions), drawn from the CPU generator ``gen``."""
    dims = [in_dim] + [cfg.hidden] * cfg.layers
    params = {"layers": [_dense(gen, dims[i], dims[i + 1], math.sqrt(2.0 / dims[i]), device)
                         for i in range(len(dims) - 1)]}
    params["head_lat"] = _dense(gen, cfg.hidden, 1, 0.01, device)
    params["head_area"] = _dense(gen, cfg.hidden, 1, 0.01, device)
    if energy:
        params["head_energy"] = _dense(gen, cfg.hidden, 1, 0.01, device)
    return params


# the reference's MLP parameters, numpy leaves (``jax.tree.map(np.asarray,
# params)``), as the port's: the same nesting, as tensors on ``device``
params_from_reference = tree_from_numpy


def _trunk(params, x, *, dropout_gen=None, dropout=0.0):
    h = x
    for lyr in params["layers"]:
        h = torch.relu(h @ lyr["w"] + lyr["b"])
        if dropout_gen is not None and dropout > 0:
            keep = torch.rand(h.shape, generator=dropout_gen, device=h.device) < 1 - dropout
            h = torch.where(keep, h / (1 - dropout), 0.0)
    return h


def _head(params, name, h):
    return (h @ params[name]["w"] + params[name]["b"])[:, 0]


def mlp_forward(params, x, *, dropout_gen=None, dropout=0.0):
    h = _trunk(params, x, dropout_gen=dropout_gen, dropout=dropout)
    return _head(params, "head_lat", h), _head(params, "head_area", h)


def mlp_forward_all(params, x, *, dropout_gen=None, dropout=0.0):
    """(latency, area, energy-or-None) normalized head outputs."""
    h = _trunk(params, x, dropout_gen=dropout_gen, dropout=dropout)
    energy = (_head(params, "head_energy", h)
              if params.get("head_energy") is not None else None)
    return _head(params, "head_lat", h), _head(params, "head_area", h), energy


@dataclasses.dataclass
class CostModel:
    params: dict
    mu: np.ndarray  # (2,) or (3,) target means (log space; 3rd = energy)
    sigma: np.ndarray
    feature_fn: Callable[[np.ndarray], np.ndarray]

    @property
    def has_energy(self) -> bool:
        """Whether the model was trained with the third (energy) head."""
        return self.params.get("head_energy") is not None

    def _heads(self, feats: np.ndarray):
        x = torch.as_tensor(np.asarray(feats), dtype=torch.float32,
                            device=self.params["layers"][0]["w"].device)
        with torch.no_grad():
            outs = mlp_forward_all(self.params, x)
        return [None if o is None else o.cpu().numpy() for o in outs]

    def predict(self, feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """feats (N, F) -> (latency_ms (N,), area_mm2 (N,))."""
        lat, area, _ = self._heads(feats)
        lat = np.exp(lat * self.sigma[0] + self.mu[0])
        area = np.exp(area * self.sigma[1] + self.mu[1])
        return lat, area

    def predict_all(self, feats: np.ndarray) -> dict:
        """feats (N, F) -> {"latency_ms", "area_mm2", "energy_mj"} arrays
        (``energy_mj`` is ``None`` without the energy head)."""
        lat, area, energy = self._heads(feats)
        out = {
            "latency_ms": np.exp(lat * self.sigma[0] + self.mu[0]),
            "area_mm2": np.exp(area * self.sigma[1] + self.mu[1]),
            "energy_mj": None,
        }
        if energy is not None:
            out["energy_mj"] = np.exp(energy * self.sigma[2] + self.mu[2])
        return out


def generate_dataset(
    nas_space: Space,
    has_space: Space,
    n: int,
    seed: int = 0,
    batch_size: int = 1,
    include_energy: bool = False,
):
    """Random (α, h) samples labelled by the simulator.
    Returns (features (N,F), latency_ms (N,), area_mm2 (N,)) — plus
    energy_mj (N,) when ``include_energy`` (the energy-head training
    labels); invalid configs are resampled (they get reward -1 in the
    search itself, but the cost model trains on valid points, matching the
    paper's setup).

    Labelling goes through the vectorized ``simulator.simulate_batch`` in
    chunks — this is what keeps "labelling 500k cost-model samples" cheap.
    Candidates are drawn pairwise in the same order as the original
    one-at-a-time loop, so the dataset is unchanged for a given seed."""
    rng = np.random.default_rng(seed)
    feats, lats, areas, energies = [], [], [], []
    while len(feats) < n:
        # capped so a 500k-sample run never materializes all candidate
        # matrices at once (peak memory stays bounded); floored so the tail
        # of resampling still amortizes
        chunk = min(max(64, n - len(feats)), 8192)
        pairs = [(nas_space.sample(rng), has_space.sample(rng))
                 for _ in range(chunk)]
        specs = [nas_space.decode(av) for av, _ in pairs]
        hs = [has_space.decode(hv) for _, hv in pairs]
        sims = simulator.simulate_batch(specs, hs, batch=batch_size)
        for (av, hv), res in zip(pairs, sims):
            if res is None:
                continue
            feats.append(np.concatenate([nas_space.features(av),
                                         has_space.features(hv)]))
            lats.append(res["latency_ms"])
            areas.append(res["area_mm2"])
            energies.append(res["energy_mj"])
            if len(feats) == n:
                break
    if include_energy:
        return (np.stack(feats), np.array(lats), np.array(areas),
                np.array(energies))
    return np.stack(feats), np.array(lats), np.array(areas)


def _adam(theta, m, v, g, t: int, lr: float) -> None:
    """One step of the reference's hand-written Adam (β 0.9 / 0.999, bias
    correction, eps 1e-8), in place on the flat parameter vector and its
    moments."""
    # in float32, as the reference computes them (its step count is a float32)
    bc1 = float(np.float32(1) - np.float32(0.9) ** np.float32(t))
    bc2 = float(np.float32(1) - np.float32(0.999) ** np.float32(t))
    with torch.no_grad():
        m.mul_(0.9).add_(g, alpha=0.1)
        v.mul_(0.999).addcmul_(g, g, value=0.001)
        theta.addcdiv_(m, torch.sqrt(v / bc2).add_(1e-8), value=-lr / bc1)


def train(
    feats: np.ndarray,
    lat_ms: np.ndarray,
    area_mm2: np.ndarray,
    cfg: CostModelConfig = CostModelConfig(),
    val_frac: float = 0.1,
    energy_mj: Optional[np.ndarray] = None,
    device="cuda",
    dropout_seed: Optional[int] = None,
) -> tuple[CostModel, dict]:
    """Passing ``energy_mj`` labels adds the third (energy) head on the
    shared trunk with the same log-standardize treatment; without them the
    training run is unchanged down to the RNG stream (two-head models stay
    reproducible). Trains on ``device``; the model's parameters stay there.
    The dropout masks draw from ``dropout_seed`` (default ``cfg.seed``), so
    their spread can be measured with the init and batches held fixed."""
    n, fdim = feats.shape
    n_val = max(1, int(n * val_frac))
    idx = np.random.default_rng(cfg.seed).permutation(n)
    tr, va = idx[n_val:], idx[:n_val]

    cols = [np.log(lat_ms), np.log(area_mm2)]
    if energy_mj is not None:
        cols.append(np.log(energy_mj))
    y = np.stack(cols, axis=1)
    mu = y[tr].mean(0)
    sigma = y[tr].std(0) + 1e-8
    yn = (y - mu) / sigma

    def on_device(a):
        return torch.as_tensor(a, dtype=torch.float32).to(device)

    x_tr, y_tr, x_va = on_device(feats[tr]), on_device(yn[tr]), on_device(feats[va])

    params = init_mlp(torch.Generator().manual_seed(cfg.seed), fdim, cfg,
                      energy=energy_mj is not None, device=device)
    # every parameter lives in one flat vector, so a step's Adam is a few
    # elementwise ops whatever the number of leaves; the tree is views of it
    leaves = tree_leaves(params)
    shapes, sizes = [p.shape for p in leaves], [p.numel() for p in leaves]
    theta = torch.cat([p.reshape(-1) for p in leaves])
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)

    def unflatten(flat):
        return tree_unflatten(params, [part.view(shape) for part, shape
                                       in zip(torch.split(flat, sizes), shapes)])

    dropout_gen = torch.Generator(device=device).manual_seed(
        cfg.seed if dropout_seed is None else dropout_seed)

    def loss_fn(p, xb, yb):
        lat, area, energy = mlp_forward_all(p, xb, dropout_gen=dropout_gen,
                                            dropout=cfg.dropout)
        # Eq. 7: MSE(area) + λ MSE(latency) [+ λ_e MSE(energy)]
        loss = torch.mean((area - yb[:, 1]) ** 2) + cfg.lam * torch.mean(
            (lat - yb[:, 0]) ** 2
        )
        if energy is not None:
            loss = loss + cfg.lam_energy * torch.mean((energy - yb[:, 2]) ** 2)
        return loss

    # the reference's sampler, one draw per step (a single bulk draw would
    # split numpy's buffered 32-bit stream differently), uploaded once
    rng_np = np.random.default_rng(cfg.seed + 1)
    n_tr = len(tr)
    draws = [rng_np.integers(0, n_tr, cfg.batch) for _ in range(cfg.steps)]
    batches = torch.from_numpy(np.stack(draws)).to(device) if draws else None
    theta.requires_grad_(True)
    for t in range(1, cfg.steps + 1):
        bi = batches[t - 1]
        with torch.enable_grad():
            loss = loss_fn(unflatten(theta), x_tr[bi], y_tr[bi])
            (g,) = torch.autograd.grad(loss, theta)
        _adam(theta, m, v, g, t, cfg.lr)
    params = unflatten(theta.detach())

    with torch.no_grad():
        lat_p, area_p, energy_p = mlp_forward_all(params, x_va)
    lat_pred = np.exp(lat_p.cpu().numpy() * sigma[0] + mu[0])
    area_pred = np.exp(area_p.cpu().numpy() * sigma[1] + mu[1])
    lat_true = lat_ms[va]
    area_true = area_mm2[va]
    metrics = {
        "val_latency_mape": float(
            np.mean(np.abs(lat_pred - lat_true) / lat_true)),
        "val_area_mape": float(
            np.mean(np.abs(area_pred - area_true) / area_true)),
        "val_latency_r2": float(
            1 - np.var(np.log(lat_pred) - np.log(lat_true))
            / np.var(np.log(lat_true))),
        "n_train": int(n_tr),
        "n_val": int(n_val),
    }
    if energy_p is not None:
        energy_pred = np.exp(energy_p.cpu().numpy() * sigma[2] + mu[2])
        energy_true = energy_mj[va]
        metrics["val_energy_mape"] = float(
            np.mean(np.abs(energy_pred - energy_true) / energy_true))
    model = CostModel(params=params, mu=mu, sigma=sigma, feature_fn=lambda f: f)
    return model, metrics

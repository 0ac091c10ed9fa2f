"""Search controllers (PyTorch counterpart of ``repro/core/controllers.py``).

* ``PPOController`` — the paper's multi-trial controller (Sec. 3.5.1):
  clipped-surrogate PPO over a factorized-categorical policy (one softmax per
  decision point), Adam lr 5e-4, gradient clip 1.0.
* ``ReinforceController`` — the oneshot controller (Sec. 3.5.2, following
  TuNAS): REINFORCE with an exponential-moving-average baseline (momentum
  0.95), Adam lr 0.0048, optional absolute-reward transform.
* ``EvolutionController`` — regularized evolution (a numpy copy of the
  reference's).

The factorized-categorical controllers keep the whole policy as ONE padded
``(D, C_max)`` float32 logits tensor on ``device`` with a validity mask
(padding pinned at ``-1e9``, its gradients masked to zero). ``sample(n)``
stays numpy: it reads the logits as float64 on the host and draws the whole
batch from one ``rng.random((n, D))`` call against per-decision CDFs, so
given equal logits and RNG state it is bitwise-equal to the reference.
``update(vecs, rewards)`` is one torch function per (kind, mask, config,
device): the old log-probs, the epoch loop, the global-norm clip and the
Adam step, op for op as the reference's jitted update.

``state()``/``load_state()`` keep the reference's numpy format (trajectory
version 2), so a controller state carries across the two implementations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.space import Space
from repro_torch.obs import trace as obs_trace

#: trajectory contract version of the vectorized factorized-categorical
#: sampler/update (see module docstring)
TRAJECTORY_VERSION = 2

# padding logit: large-negative instead of -inf so exp() underflows to an
# exact 0.0 without spawning nan through 0 * -inf in the entropy term
_PAD = -1e9


def _pack_space(space: Space, device) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """(D, C_max) zero logits with ``_PAD`` padding, validity mask, arity."""
    arity = np.asarray(space.arity, np.int64)
    mask = np.arange(int(arity.max()))[None, :] < arity[:, None]
    logits = torch.where(torch.from_numpy(mask), 0.0, _PAD).to(torch.float32)
    return logits.to(device), mask, arity


def _v1_state_error(ctrl: str) -> ValueError:
    return ValueError(
        f"{ctrl} checkpoint was written by the trajectory v1 (per-draw) "
        f"sampler; this build runs trajectory v{TRAJECTORY_VERSION} (one "
        f"vectorized draw per batch), which consumes the RNG differently — "
        f"resuming would silently diverge from the original run. Restart "
        f"the search from scratch (delete the checkpoint tag) or re-run it "
        f"on the build that wrote it."
    )



def _as_logits(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


class _CategoricalPolicy:
    """Shared machinery: padded logits tensor + cached sampling CDF."""

    def __init__(self, space: Space, seed: int, device):
        self.space = space
        self.device = torch.device(device)
        self.logits, self._mask, self._arity = _pack_space(space, self.device)
        self.rng = np.random.default_rng(seed)
        self._cdf: Optional[np.ndarray] = None

    def _set_logits(self, logits: torch.Tensor) -> None:
        self.logits = logits
        self._cdf = None  # lazily rebuilt on the next sample()

    def _host_logits(self) -> np.ndarray:
        return self.logits.detach().cpu().numpy().astype(np.float64)

    def warm_start(self, offset: int, base_vec, logit: float) -> None:
        """Pin the hot-start options (search.SearchConfig.hot_start)."""
        idx = torch.as_tensor(np.asarray(base_vec, np.int64))
        rows = torch.arange(len(idx)) + offset
        lg = self.logits.clone()
        lg[rows.to(self.device), idx.to(self.device)] = logit
        self._set_logits(lg)

    def transfer_from(self, state: dict) -> None:
        """Warm-start this controller from a *donor* search's checkpointed
        controller state: adopt the donor's policy logits, keep this
        controller's own RNG stream and fresh optimizer moments. Raises
        ``ValueError`` for a different trajectory version or an
        incompatible (differently shaped) space."""
        if state.get("version") != TRAJECTORY_VERSION:
            raise ValueError(
                f"transfer donor snapshot is trajectory "
                f"v{state.get('version')}, this build runs "
                f"v{TRAJECTORY_VERSION}"
            )
        logits = np.asarray(state["logits"])
        if tuple(logits.shape) != tuple(self.logits.shape):
            raise ValueError(
                f"transfer donor logits shape {tuple(logits.shape)} does not "
                f"match this space's {tuple(self.logits.shape)} — "
                f"incompatible search space"
            )
        self._set_logits(_as_logits(logits, self.device))

    def sample(self, n: int) -> np.ndarray:
        """Draw ``n`` decision vectors with ONE generator call: inverse-CDF
        over the per-decision categorical distributions. The (D, C_max) CDF
        is recomputed only when the logits changed."""
        with obs_trace.span("controller_sample", n=n, ctrl=type(self).__name__):
            return self._sample(n)

    def _sample(self, n: int) -> np.ndarray:
        if self._cdf is None:
            lg = np.where(self._mask, self._host_logits(), -np.inf)
            lg -= lg.max(axis=1, keepdims=True)
            p = np.exp(lg)
            cdf = np.cumsum(p, axis=1)
            cdf /= cdf[:, -1:]  # exact 1.0 past the last live option
            self._cdf = cdf
        u = self.rng.random((n, len(self._arity)))
        idx = (u[:, :, None] >= self._cdf[None, :, :]).sum(axis=2)
        return np.minimum(idx, self._arity - 1).astype(np.int32)

    def best(self) -> np.ndarray:
        lg = np.where(self._mask, self._host_logits(), -np.inf)
        return lg.argmax(axis=1).astype(np.int32)

    def _moments_state(self) -> dict:
        return {
            "version": TRAJECTORY_VERSION,
            "logits": self.logits.detach().cpu().numpy(),
            "adam": {
                "m": self.opt_m.detach().cpu().numpy(),
                "v": self.opt_v.detach().cpu().numpy(),
                "t": int(self.opt_t),
            },
            "rng": self.rng.bit_generator.state,
        }

    def _load_moments(self, state: dict) -> None:
        self._set_logits(_as_logits(state["logits"], self.device))
        self.opt_m = _as_logits(state["adam"]["m"], self.device)
        self.opt_v = _as_logits(state["adam"]["v"], self.device)
        self.opt_t = int(state["adam"]["t"])
        self.rng.bit_generator.state = state["rng"]


def _masked_logp_entropy(logits, mask, vecs):
    """Summed per-vector log-probs (n,) and total entropy over decisions."""
    lsm = torch.log_softmax(torch.where(mask, logits, _PAD), dim=1)
    d = torch.arange(logits.shape[0], device=logits.device)
    lp = lsm[d[None, :], vecs].sum(dim=1)
    ent = -torch.sum(torch.where(mask, torch.exp(lsm) * lsm, 0.0))
    return lp, ent


def _adam_step(lg, m, v, t, g, mask, lr, clip):
    """One clipped Adam step on the logits matrix (padding frozen)."""
    g = torch.where(mask, g, 0.0)
    gn = torch.sqrt(torch.sum(g * g) + 1e-12)
    g = g * torch.clamp(clip / gn, max=1.0)
    t = t + 1
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g**2
    bc1 = 1 - 0.9**t
    bc2 = 1 - 0.999**t
    lg = lg - lr * (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
    return lg, m, v, t


def _grad(loss_of, lg):
    """d loss_of(lg) / d lg."""
    lg = lg.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(loss_of(lg), lg)
    return g


# Update functions, shared across controller INSTANCES and keyed by
# (kind, mask, config, device): everything the closure bakes in — the
# counterpart of the reference's compiled-update cache.
_UPDATE_CACHE: dict = {}


def _cached_update(kind: str, mask, cfg, device, builder):
    key = (kind, mask.shape, mask.tobytes(), dataclasses.astuple(cfg), str(device))
    fn = _UPDATE_CACHE.get(key)
    if fn is None:
        fn = _UPDATE_CACHE[key] = builder()
    return fn


@dataclasses.dataclass
class PPOConfig:
    lr: float = 5e-4
    clip_eps: float = 0.2
    epochs: int = 3
    entropy_coef: float = 1e-3
    grad_clip: float = 1.0
    trials_per_sample: int = 1  # paper: reward = mean of 10 trials


class PPOController(_CategoricalPolicy):
    def __init__(self, space: Space, cfg: PPOConfig = PPOConfig(), seed: int = 0,
                 device="cuda"):
        super().__init__(space, seed, device)
        self.cfg = cfg
        self.opt_m = torch.zeros_like(self.logits)
        self.opt_v = torch.zeros_like(self.logits)
        self.opt_t = 0
        self.baseline = 0.0
        self._b_init = False

    def _update_fn(self):
        """The fused update: old log-probs + the whole epoch loop (grad,
        clip, Adam) on the (D, C_max) tensor. Built once per (mask, config,
        device) and shared across instances."""
        fn = getattr(self, "_update", None)
        if fn is not None:
            return fn
        cfg = self.cfg
        maskt = torch.from_numpy(self._mask).to(self.device)
        n_dec = self._mask.shape[0]

        def build():
            def update(lg, m, v, t, vecs, adv):
                with torch.no_grad():
                    old, _ = _masked_logp_entropy(lg, maskt, vecs)

                def loss_of(lg):
                    lp, ent = _masked_logp_entropy(lg, maskt, vecs)
                    ratio = torch.exp(lp - old)
                    clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps)
                    obj = torch.mean(torch.minimum(ratio * adv, clipped * adv))
                    return -(obj + cfg.entropy_coef * ent / n_dec)

                for _ in range(cfg.epochs):
                    g = _grad(loss_of, lg)
                    lg, m, v, t = _adam_step(lg, m, v, t, g, maskt, cfg.lr,
                                             cfg.grad_clip)
                return lg, m, v, t

            return update

        self._update = _cached_update("ppo", self._mask, cfg, self.device, build)
        return self._update

    def update(self, vecs: np.ndarray, rewards: np.ndarray):
        with obs_trace.span("controller_update", n=len(vecs), ctrl=type(self).__name__):
            rewards = np.asarray(rewards, np.float32)
            if not self._b_init:
                self.baseline = float(rewards.mean())
                self._b_init = True
            adv = rewards - self.baseline
            if adv.std() > 1e-8:
                adv = adv / (adv.std() + 1e-8)
            self.baseline = 0.9 * self.baseline + 0.1 * float(rewards.mean())
            lg, self.opt_m, self.opt_v, self.opt_t = self._update_fn()(
                self.logits,
                self.opt_m,
                self.opt_v,
                int(self.opt_t),
                torch.as_tensor(np.asarray(vecs, np.int64), device=self.device),
                torch.as_tensor(np.asarray(adv, np.float32), device=self.device),
            )
            self._set_logits(lg)

    def state(self) -> dict:
        return {**self._moments_state(), "baseline": self.baseline,
                "b_init": self._b_init}

    def load_state(self, state: dict) -> None:
        if state.get("version") != TRAJECTORY_VERSION:
            raise _v1_state_error("PPOController")
        self._load_moments(state)
        self.baseline = state["baseline"]
        self._b_init = state["b_init"]

    def transfer_from(self, state: dict) -> None:
        super().transfer_from(state)
        # the donor's reward baseline is a decent prior for a *nearby*
        # objective; the first warm batch then gets a meaningful advantage
        # signal instead of re-bootstrapping from its own mean
        self.baseline = float(state.get("baseline", 0.0))
        self._b_init = bool(state.get("b_init", False))


@dataclasses.dataclass
class ReinforceConfig:
    lr: float = 0.0048
    baseline_momentum: float = 0.95
    entropy_coef: float = 1e-4
    absolute_reward: bool = True  # TuNAS |r - baseline| shaping


class ReinforceController(_CategoricalPolicy):
    def __init__(
        self, space: Space, cfg: ReinforceConfig = ReinforceConfig(), seed: int = 0,
        device="cuda",
    ):
        super().__init__(space, seed, device)
        self.cfg = cfg
        self.opt_m = torch.zeros_like(self.logits)
        self.opt_v = torch.zeros_like(self.logits)
        self.opt_t = 0
        self.baseline = None

    def _update_fn(self):
        fn = getattr(self, "_update", None)
        if fn is not None:
            return fn
        cfg = self.cfg
        maskt = torch.from_numpy(self._mask).to(self.device)
        n_dec = self._mask.shape[0]

        def build():
            def update(lg, m, v, t, vecs, adv):
                def loss_of(lg):
                    lp, ent = _masked_logp_entropy(lg, maskt, vecs)
                    return -(torch.mean(lp * adv) + cfg.entropy_coef * ent / n_dec)

                g = _grad(loss_of, lg)
                return _adam_step(lg, m, v, t, g, maskt, cfg.lr, 1.0)

            return update

        self._update = _cached_update("reinforce", self._mask, cfg, self.device,
                                      build)
        return self._update

    def update(self, vecs: np.ndarray, rewards: np.ndarray):
        with obs_trace.span("controller_update", n=len(vecs), ctrl=type(self).__name__):
            rewards = np.asarray(rewards, np.float32)
            if self.baseline is None:
                self.baseline = float(rewards.mean())
            adv = rewards - self.baseline
            m = self.cfg.baseline_momentum
            self.baseline = m * self.baseline + (1 - m) * float(rewards.mean())
            lg, self.opt_m, self.opt_v, self.opt_t = self._update_fn()(
                self.logits,
                self.opt_m,
                self.opt_v,
                int(self.opt_t),
                torch.as_tensor(np.asarray(vecs, np.int64), device=self.device),
                torch.as_tensor(np.asarray(adv, np.float32), device=self.device),
            )
            self._set_logits(lg)

    def sample(self, n: int = 1) -> np.ndarray:
        return super().sample(n)

    def state(self) -> dict:
        return {**self._moments_state(), "baseline": self.baseline}

    def load_state(self, state: dict) -> None:
        if state.get("version") != TRAJECTORY_VERSION:
            raise _v1_state_error("ReinforceController")
        self._load_moments(state)
        self.baseline = state["baseline"]

    def transfer_from(self, state: dict) -> None:
        super().transfer_from(state)
        b = state.get("baseline")
        self.baseline = None if b is None else float(b)


@dataclasses.dataclass
class EvolutionConfig:
    population: int = 64
    tournament: int = 8
    mutate_rate: float = 0.1


class EvolutionController:
    """Regularized evolution (ablation baseline)."""

    def __init__(
        self, space: Space, cfg: EvolutionConfig = EvolutionConfig(), seed: int = 0
    ):
        self.space = space
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.population: list[tuple[np.ndarray, float]] = []

    def sample(self, n: int = 1) -> np.ndarray:
        with obs_trace.span("controller_sample", n=n, ctrl="EvolutionController"):
            out = []
            for _ in range(n):
                if len(self.population) < self.cfg.population:
                    out.append(self.space.sample(self.rng))
                else:
                    idx = self.rng.choice(
                        len(self.population), size=self.cfg.tournament,
                        replace=False,
                    )
                    parent = max(
                        (self.population[i] for i in idx), key=lambda t: t[1]
                    )[0]
                    out.append(
                        self.space.mutate(parent, self.rng, self.cfg.mutate_rate)
                    )
            return np.stack(out)

    def update(self, vecs: np.ndarray, rewards: np.ndarray):
        with obs_trace.span("controller_update", n=len(vecs),
                            ctrl="EvolutionController"):
            for v, r in zip(vecs, rewards):
                self.population.append((np.asarray(v), float(r)))
                if len(self.population) > self.cfg.population:
                    self.population.pop(0)  # age-regularized: drop oldest

    def best(self) -> np.ndarray:
        return max(self.population, key=lambda t: t[1])[0]

    def transfer_from(self, state: dict) -> None:
        """Scenario-transfer for evolution: seed the population with the
        donor's. The donor's rewards were earned under *its* objective, so
        they only bias early tournament selection — this search's own
        updates replace them within one population turnover. RNG stays this
        controller's own seeded stream."""
        pop = state.get("population")
        if not pop:
            raise ValueError("transfer donor snapshot has no population")
        want = (len(self.space.arity),)
        vecs = [np.asarray(v) for v, _ in pop]
        if any(v.shape != want for v in vecs):
            raise ValueError(
                f"transfer donor population vectors have shape "
                f"{vecs[0].shape}, this space needs {want} — "
                f"incompatible search space"
            )
        keep = self.cfg.population
        self.population = [(v, float(r)) for v, (_, r) in zip(vecs, pop)][-keep:]

    def state(self) -> dict:
        return {
            "rng": self.rng.bit_generator.state,
            "population": [(np.asarray(v), r) for v, r in self.population],
        }

    def load_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self.population = [(np.asarray(v), float(r)) for v, r in state["population"]]


CONTROLLERS = {
    "ppo": PPOController,
    "reinforce": ReinforceController,
    "evolution": EvolutionController,
}

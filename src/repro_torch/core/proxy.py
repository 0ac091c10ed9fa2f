"""Accuracy signals for the search.

Two paths, both implemented (DESIGN.md §2):

* ``SurrogateAccuracy`` — an analytic stand-in for ImageNet top-1, calibrated
  on the paper's own Table 3 anchors: EfficientNet-B0/B1/B3 (wo SE/Swish) at
  (0.39, 0.70, 1.8) GFLOPs → (74.7, 76.9, 78.8)%:
      acc = 80.371 - 2.573 * GFLOPs^-0.839  (exact on all three anchors)
  plus a small param-count term, an SE/Swish bonus, and deterministic
  per-architecture noise. Used for large sweeps (5000-sample PPO runs are not
  feasible as real ImageNet trainings in this container — the paper itself
  needed thousands of accelerator-days for those).

  ``batch(specs)`` is the search hot path: flops/params come from the
  cached ``simulator.layer_matrix`` scalars (one bounded memo shared with
  the batched simulator) and the accuracy terms are computed as one numpy
  pass over the batch — bitwise-identical to the per-spec reference
  formula (``_reference``), hash-seeded noise included, which is what
  keeps records stable across the scalar and batched paths.

* ``TrainedAccuracy`` — a *real* proxy task: train the candidate on the
  synthetic vision stream for a few hundred steps and measure held-out
  accuracy (the paper's 5-epoch proxy-task pattern). In the port it trains
  on ``device`` (the card by default), with every 1×1 convolution of the
  candidate on the ``ibn_pointwise`` kernel; ``train_step`` is its single
  SGD step. On the card it trains under ``CUDNN_FLAGS`` (TF32 off, cuDNN's
  deterministic algorithms) with matmul TF32 off, whatever the process set,
  so a spec's accuracy is the same in every process: the sweep's process
  workers then reproduce the serial run bitwise. The flags are the
  process's, not the thread's, so ``CARD_FLAGS`` holds them while any
  thread trains on the card and gives the process its own back only when
  the last one leaves: threads that train at once (an admission pool, a
  thread-mode sweep) each get what they get alone. ``prepare`` builds the
  kernel before a process pool spawns or a thread pool starts.

* ``CachedAccuracy`` — a memoizing wrapper for either signal, keyed on the
  (frozen, hashable) ``ConvNetSpec``, with FIFO eviction at the size cap
  and a one-dict-pass ``batch`` API that fans misses out to the wrapped
  signal's own ``batch`` when it has one. The ``EvaluationEngine`` caches
  whole records by encoded vector; this wrapper additionally collapses
  *distinct* vectors that decode to the same architecture (common in the
  evolved space, where infeasible group counts fall back to ``groups=1``).

Counterpart of ``repro/core/proxy.py``: the surrogate and the cache are
copies, ``TrainedAccuracy`` is torch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading

import numpy as np
import torch

from repro_torch.common import FifoDict, tree_leaves, tree_unflatten
from repro_torch.core import simulator
from repro_torch.data.synthetic import VisionStream
from repro_torch.kernels import ibn_conv
from repro_torch.models import convnets as C

#: the cuDNN settings ``TrainedAccuracy`` trains under on the card (module
#: doc); None leaves the process's own
CUDNN_FLAGS = {"enabled": True, "benchmark": False, "deterministic": True,
               "allow_tf32": False}


class FlagHold:
    """Holds process-global flags for as long as any thread is inside
    ``held``: the first thread in saves the process's own (``read()``) and
    sets the given ones (``write(flags)``), the last one out writes the
    saved ones back. Threads in between find the flags set and leave them."""

    def __init__(self, read, write):
        self._read = read
        self._write = write
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    @contextlib.contextmanager
    def held(self, flags: dict):
        with self._lock:
            if self._depth == 0:
                self._saved = self._read()
                self._write(flags)
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    self._write(self._saved)
                    self._saved = None


def _read_card_flags() -> dict:
    cudnn = torch.backends.cudnn
    return {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "enabled": cudnn.enabled, "benchmark": cudnn.benchmark,
            "deterministic": cudnn.deterministic, "allow_tf32": cudnn.allow_tf32}


def _write_card_flags(flags: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = flags["matmul_allow_tf32"]
    cudnn = torch.backends.cudnn
    cudnn.enabled = flags["enabled"]
    cudnn.benchmark = flags["benchmark"]
    cudnn.deterministic = flags["deterministic"]
    cudnn.allow_tf32 = flags["allow_tf32"]


#: the training flags of every thread that trains on a card (module doc)
CARD_FLAGS = FlagHold(_read_card_flags, _write_card_flags)

# Table-3-calibrated constants (see module docstring)
_A, _B, _G = 80.37137624, 2.57339702, 0.83920754


def _spec_hash(spec: C.ConvNetSpec) -> int:
    s = repr(spec).encode()
    return int(hashlib.sha256(s).hexdigest()[:8], 16)


# spec -> (gflops, params_m), derived from the cached (9, L) layer matrix.
# Exact small integers in float64 (< 2^53), so the sums — and therefore the
# accuracy formula downstream — are bitwise-equal to the integer
# ``convnets.count_flops`` / ``count_params`` loops.
_FP_CACHE: FifoDict = FifoDict(65536)


def _flops_params(spec: C.ConvNetSpec) -> tuple[float, float]:
    s = _FP_CACHE.get(spec)
    if s is not None:
        return s
    m = simulator.layer_matrix(spec)
    is_dw = m[0] != 0.0
    cin, cout, k, grp, out_hw = m[3], m[4], m[5], m[7], m[8]
    k2 = k * k
    fl = np.where(
        is_dw,
        2.0 * out_hw * cout * k2,
        np.floor_divide(2.0 * out_hw * cout * k2 * cin, grp),
    ).sum()
    pb = np.where(is_dw, k2 * cout, k2 * np.floor_divide(cin, grp) * cout).sum()
    s = (float(fl) / 1e9, float(pb) / 1e6)
    _FP_CACHE[spec] = s
    return s


@dataclasses.dataclass
class SurrogateAccuracy:
    noise_pct: float = 0.12
    se_swish_bonus: float = 0.55  # Table 3: MobilenetV3 w SE vs similar capacity

    def __call__(self, spec: C.ConvNetSpec) -> float:
        return self.batch([spec])[0]

    def batch(self, specs: list) -> list[float]:
        """Vectorized scoring of a spec batch (see module docstring). One
        numpy pass over the batch for the analytic terms; the hash-seeded
        per-spec noise draw is preserved bitwise."""
        n = len(specs)
        if n == 0:
            return []
        gflops = np.empty(n)
        params_m = np.empty(n)
        se = np.zeros(n)
        swish = np.zeros(n)
        ks_div = np.empty(n)
        noise = np.empty(n)
        for i, spec in enumerate(specs):
            gflops[i], params_m[i] = _flops_params(spec)
            if any(blk.se for blk in spec.blocks):
                se[i] = self.se_swish_bonus * 0.6
            if any(blk.act == "swish" for blk in spec.blocks):
                swish[i] = self.se_swish_bonus * 0.4
            ks = {blk.kernel for blk in spec.blocks}
            ks_div[i] = 0.1 * (len(ks) - 1)
            rng = np.random.default_rng(_spec_hash(spec))
            noise[i] = rng.normal(0.0, self.noise_pct)
        # one addition per term, in _reference's order — float addition is
        # order-sensitive, and a conditional term that adds 0.0 is a
        # bitwise no-op, so the two paths agree bit for bit
        acc = _A - _B * np.maximum(gflops, 0.05) ** (-_G)
        acc = acc + (0.35 * np.log1p(params_m) - 0.35 * np.log1p(5.3))
        acc = acc + se
        acc = acc + swish
        acc = acc + ks_div
        acc = acc + noise
        return [float(a) / 100.0 for a in np.clip(acc, 1.0, 99.0)]

    def _reference(self, spec: C.ConvNetSpec) -> float:
        """The original per-spec formula, kept as the bitwise reference the
        vectorized ``batch`` is tested against (tests/test_search_loop.py)."""
        gflops = C.count_flops(spec) / 1e9
        params_m = C.count_params(spec) / 1e6
        acc = _A - _B * max(gflops, 0.05) ** (-_G)
        acc += 0.35 * np.log1p(params_m) - 0.35 * np.log1p(5.3)
        if any(b.se for b in spec.blocks):
            acc += self.se_swish_bonus * 0.6
        if any(b.act == "swish" for b in spec.blocks):
            acc += self.se_swish_bonus * 0.4
        # kernel-size diversity gives a small, saturating gain
        ks = {b.kernel for b in spec.blocks}
        acc += 0.1 * (len(ks) - 1)
        rng = np.random.default_rng(_spec_hash(spec))
        acc += rng.normal(0.0, self.noise_pct)
        return float(np.clip(acc, 1.0, 99.0)) / 100.0


class CachedAccuracy:
    """Memoizes an accuracy signal by architecture spec (see module docstring).

    The underlying signal must be deterministic per spec — true for both
    ``SurrogateAccuracy`` (hash-seeded noise) and ``TrainedAccuracy`` (fixed
    training seed). The cache evicts FIFO at ``max_entries`` instead of
    clearing wholesale.
    """

    def __init__(self, fn, max_entries: int = 1_000_000):
        self.fn = fn
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self._cache: FifoDict = FifoDict(max_entries)

    def __call__(self, spec: C.ConvNetSpec) -> float:
        acc = self._cache.get(spec)
        if acc is not None:
            self.hits += 1
            return acc
        self.misses += 1
        acc = self.fn(spec)
        self._cache[spec] = acc
        return acc

    def batch(self, specs: list) -> list[float]:
        """One dict pass over the batch: cache hits fan out, in-batch
        duplicates collapse, and the misses go to the wrapped signal's own
        ``batch`` (one vectorized call) when it provides one."""
        out: list = [None] * len(specs)
        first: dict = {}
        missing: list[int] = []
        dups: list[int] = []
        for i, spec in enumerate(specs):
            acc = self._cache.get(spec)
            if acc is not None:
                self.hits += 1
                out[i] = acc
            elif spec in first:
                self.hits += 1
                dups.append(i)
            else:
                first[spec] = i
                missing.append(i)
                self.misses += 1
        if missing:
            todo = [specs[i] for i in missing]
            # callable() matters: TrainedAccuracy has an *int* field named
            # ``batch`` (its training batch size), not a batch API
            fb = getattr(self.fn, "batch", None)
            accs = fb(todo) if callable(fb) else [self.fn(s) for s in todo]
            for i, acc in zip(missing, accs):
                self._cache[specs[i]] = acc
                out[i] = acc
        for i in dups:
            out[i] = out[first[specs[i]]]
        return out



def loss_fn(params: dict, images, labels, spec: C.ConvNetSpec):
    """Mean softmax cross-entropy of the candidate's logits."""
    logits = C.forward(params, images, spec)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    return torch.mean(logz - gold)


def train_step(params: dict, images, labels, spec: C.ConvNetSpec, lr: float):
    """One plain SGD step: returns (new params, loss before the step)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), images, labels, spec)
        grads = torch.autograd.grad(loss, leaves)
    new = [(p - lr * g).detach() for p, g in zip(leaves, grads)]
    return tree_unflatten(params, new), loss.detach()


@dataclasses.dataclass
class TrainedAccuracy:
    """Real training on the synthetic vision task, on ``device``."""

    steps: int = 150
    batch: int = 64
    image_size: int = 32
    num_classes: int = 10
    lr: float = 0.05
    eval_batches: int = 4
    seed: int = 0
    device: str = "cuda"

    def prepare(self) -> None:
        """Build what training on the card launches (the ``ibn_pointwise``
        kernel), so process workers load it instead of each building it."""
        if torch.device(self.device).type == "cuda":
            ibn_conv.build()

    def __call__(self, spec: C.ConvNetSpec) -> float:
        if torch.device(self.device).type != "cuda" or CUDNN_FLAGS is None:
            return self._train(spec)
        with CARD_FLAGS.held({"matmul_allow_tf32": False, **CUDNN_FLAGS}):
            return self._train(spec)

    def _train(self, spec: C.ConvNetSpec) -> float:
        spec = dataclasses.replace(
            spec, image_size=self.image_size, num_classes=self.num_classes
        )
        params = C.init(self.seed, spec, device=self.device)
        stream = VisionStream(
            image_size=self.image_size,
            num_classes=self.num_classes,
            batch=self.batch,
            seed=self.seed,
        )

        def on_device(b):
            return (torch.from_numpy(b["images"]).to(self.device),
                    torch.from_numpy(b["labels"]).long().to(self.device))

        for i in range(self.steps):
            params, _ = train_step(params, *on_device(stream.batch_at(i)), spec,
                                   self.lr)

        accs = []
        with torch.no_grad():
            for i in range(self.eval_batches):
                images, labels = on_device(stream.batch_at(10_000 + i))
                logits = C.forward(params, images, spec)
                accs.append(float(torch.mean(
                    (torch.argmax(logits, -1) == labels).float())))
        return float(np.mean(accs))

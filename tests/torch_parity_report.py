"""Print the largest errors of the PyTorch port against the JAX reference on
the CPU, one row per parity check of tests/test_torch_*.py, with the
tolerance each test holds it to (the tests assert; this reports the values).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_parity_report.py
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_convnets as tc  # noqa: E402
import test_torch_kernels as tk  # noqa: E402
import test_torch_search as ts  # noqa: E402


def convnet_rows():
    logits, loss, params = 0.0, 0.0, 0.0
    for name, spec in tc.CASES.items():
        p, tp, x, y = tc._setup(spec)
        want = np.asarray(jax.jit(tc.RC.forward, static_argnums=2)(p, jnp.asarray(x), spec))
        got = tc.TC.forward(tp, torch.from_numpy(x), tc._port_spec(spec)).numpy()
        logits = max(logits, float(np.max(np.abs(got - want))))
    for name in ("mobilenet_v2", "efficientnet_b0", "manual_edgetpu_groups2", "tiny0"):
        spec = tc.CASES[name]
        p, tp, x, y = tc._setup(spec, seed=1)
        want_p, want_loss = tc._ref_step(p, jnp.asarray(x), jnp.asarray(y), spec, 0.05)
        got_p, got_loss = tc.port_proxy.train_step(
            tp, torch.from_numpy(x), torch.from_numpy(y).long(), tc._port_spec(spec), 0.05)
        loss = max(loss, abs(float(got_loss) - float(want_loss)))
        want_conv = tc.TC.params_from_reference(jax.tree.map(np.asarray, want_p), "cpu")
        for g, w in zip(tc.TC.tree_leaves(got_p), tc.TC.tree_leaves(want_conv)):
            params = max(params, torch.max(torch.abs(g - w)).item())
    return [("convnets.forward logits (6 specs, 32 px, batch 2)",
             "test_logits_match_reference", tc.LOGIT_TOL, logits),
            ("proxy.train_step loss (4 specs)", "test_train_step_matches_reference",
             tc.LOSS_TOL, loss),
            ("proxy.train_step params after one SGD step",
             "test_train_step_matches_reference", tc.PARAM_TOL, params)]


def kernel_rows():
    rows = []
    for dtype in ("float32", "bfloat16"):
        err = 0.0
        for n, ci, co, act in tk.SHAPES:
            x, w, b = tk._inputs(n, ci, co)
            jd = jnp.dtype(dtype)
            want = tk.pallas_ibn_pointwise(
                jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b, jd), act=act,
                block_n=64, block_f=32, block_k=32, interpret=True)
            td = getattr(torch, dtype)
            got = tk.ibn_pointwise_ref(*(torch.from_numpy(a).to(td) for a in (x, w, b)), act)
            err = max(err, float(np.max(np.abs(got.float().numpy()
                                               - np.asarray(want, np.float32)))))
        rows.append((f"kernels.ref.ibn_pointwise_ref vs Pallas (interpret), {dtype}",
                     "test_ref_matches_pallas_kernel", tk.TOL[dtype], err))
    err = 0.0
    for act in ("relu", "silu", "none"):
        for n, ci, co in ((96, 24, 40), (33, 7, 5)):
            x, w, b = tk._inputs(n, ci, co, seed=1)
            dy = np.random.default_rng(2).normal(size=(n, co)).astype(np.float32)
            tx, tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
            tk.ops.ibn_pointwise(tx, tw, tb, act=act).backward(torch.from_numpy(dy))
            for got, ref in zip((tx.grad, tw.grad, tb.grad), tk._jax_grads(x, w, b, dy, act)):
                err = max(err, float(np.max(np.abs(got.numpy() - np.asarray(ref)))))
    rows.append(("kernels.ibn_conv.IbnPointwise dx/dw/db vs jax.grad",
                 "test_gradient_matches_jax_grad", tk.GRAD_TOL, err))
    return rows


def controller_rows():
    rows = []
    for kind in ("ppo", "reinforce"):
        ref = ts.ref_ctl.CONTROLLERS[kind](ts.ref_nas.tiny_space(), seed=5)
        port = ts.port_ctl.CONTROLLERS[kind](ts.port_nas.tiny_space(), seed=5, device="cpu")
        rng = np.random.default_rng(0)
        ref.update(ref.sample(8), rng.normal(size=8))
        port.load_state(ref.state())
        err = 0.0
        for _ in range(3):
            vecs = ref.sample(8)
            port.sample(8)
            rewards = rng.normal(size=8)
            ref.update(vecs, rewards)
            port.update(vecs, rewards)
            a, b = port.state(), ref.state()
            err = max(err, float(np.max(np.abs(a["logits"] - b["logits"]))),
                      *(float(np.max(np.abs(a["adam"][k] - b["adam"][k]))) for k in "mv"))
        rows.append((f"controllers {kind} update: logits, m, v after 3 updates",
                     "test_controller_updates_match_reference", ts.CTRL_TOL, err))
    return rows


def main():
    rows = convnet_rows() + kernel_rows() + controller_rows()
    print("| Module or kernel | Test | Tolerance | Max error measured | Device |")
    print("|---|---|---|---|---|")
    for what, test, tol, err in rows:
        print(f"| {what} | `{test}` | {tol:g} | {err:.3g} | CPU |")


if __name__ == "__main__":
    main()

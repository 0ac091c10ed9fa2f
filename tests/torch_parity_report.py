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

import test_torch_attention as ta  # noqa: E402
import test_torch_cascade as tca  # noqa: E402
import test_torch_convnets as tc  # noqa: E402
import test_torch_costmodel as tcm  # noqa: E402
import test_torch_hybrid as th  # noqa: E402
import test_torch_kernels as tk  # noqa: E402
import test_torch_meshsearch as tms  # noqa: E402
import test_torch_moe as tm  # noqa: E402
import test_torch_oneshot as to  # noqa: E402
import test_torch_roofline as tr  # noqa: E402
import test_torch_scenarios as tsc  # noqa: E402
import test_torch_search as ts  # noqa: E402
import test_torch_ssm as tss  # noqa: E402
import test_torch_train as ttr  # noqa: E402
import test_torch_transformer as tt  # noqa: E402


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


def attention_rows():
    rows = []
    for dtype in ("float32", "bfloat16"):
        err = 0.0
        for shape in ta.SHAPES + ta.WIDE_HEADS + (ta.CAUSAL_RAGGED if dtype == "float32"
                                                  else []):
            q, k, v = ta._qkv(*shape[:6])
            err = max(err, float(np.max(np.abs(ta._plain(q, k, v, shape[6], dtype)
                                               - ta._pallas(q, k, v, shape[6], dtype)))))
        rows.append((f"kernels.ref.flash_attention_ref vs Pallas (interpret), {dtype}, "
                     "incl. hd 80 and 112"
                     + (", causal sq != skv" if dtype == "float32" else ""),
                     "test_plain_version_matches_pallas_kernel", ta.TOL[dtype], err))
    err = 0.0
    for impl, fn, jfn in (("naive", ta.TL.naive_attention, ta._naive),
                          ("chunked", ta.TL.chunked_attention, ta._chunked)):
        for q_offset, kv_len, causal in ((0, None, True), (0, None, False), (30, 35, True)):
            q, k, v = ta._model_layout(3)
            kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
            if impl == "chunked":
                kw["chunk"] = 16
            want = np.asarray(jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
            got = fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
            err = max(err, float(np.max(np.abs(got.numpy() - want))))
    rows.append(("layers.naive/chunked_attention with q_offset/kv_len",
                 "test_attention_cores_match_reference", ta.CORE_TOL, err))
    return rows


def transformer_rows():
    rows = []
    for dtype in ("float32", "bfloat16"):
        logits, cache = 0.0, 0.0
        for name in tt.CFGS:
            want_logits, want_cache = tt._reference_forward(name, dtype)
            params = tt.TT.params_from_reference(tt._params(name), "cpu")
            for impl in ("flash_pallas", "chunked"):
                cfg = tt._port(tt._cfg(name, dtype), attn_impl=impl)
                got, got_cache = tt.TT.forward(params, {"tokens": torch.from_numpy(
                    tt._tokens(name, tt.P))}, cfg, return_cache=True)
                logits = max(logits, float(tt._rel(got.numpy(), want_logits)))
                cache = max(cache, *(float(tt._rel(got_cache[n].float().numpy(), want_cache[n]))
                                     for n in "kv"))
        rows.append((f"transformer.forward logits / max, 3 configs × flash_pallas, chunked, "
                     f"{dtype} compute", "test_forward_and_cache_match_reference",
                     tt.LOGIT_TOL[dtype], logits))
        rows.append((f"transformer.forward return_cache k/v / max, {dtype} compute",
                     "test_forward_and_cache_match_reference", tt.CACHE_TOL[dtype], cache))
    err = 0.0
    for i, name in enumerate(sorted(tt.FRONTENDS)):
        cfg = tt.dataclasses.replace(tt.FRONTENDS[name], compute_dtype="float32")
        np_params = tt._draw_params(cfg, 10 + i)
        rng = np.random.default_rng(8)
        if cfg.frontend == "vision_patches":
            batch = {"patches": rng.normal(size=(tt.B, cfg.num_patches, cfg.frontend_dim)),
                     "tokens": rng.integers(0, cfg.vocab_size, size=(tt.B, tt.P))}
        else:
            batch = {"frames": rng.normal(size=(tt.B, tt.P, cfg.frontend_dim))}
        batch = {n: a.astype(np.float32 if a.dtype.kind == "f" else np.int32)
                 for n, a in batch.items()}
        want = np.asarray(tt.RT.forward(np_params, batch, cfg))
        got = tt.TT.forward(tt.TT.params_from_reference(np_params, "cpu"),
                            {n: torch.from_numpy(a) for n, a in batch.items()},
                            tt._port(cfg, attn_impl="flash_pallas"))
        err = max(err, float(tt._rel(got.numpy(), want)))
    rows.append(("transformer.forward logits / max, vlm and audio inputs (pixtral, hubert "
                 "smoke), fp32", "test_frontend_families_match_reference",
                 tt.LOGIT_TOL["float32"], err))
    for kind, (kv_dtype, lazy) in tt.KINDS.items():
        err = 0.0
        for name in tt.CFGS:
            cfg = tt.dataclasses.replace(tt._cfg(name), lazy_kv_dequant=lazy)
            toks = tt._tokens(name, tt.P + tt.STEPS)
            _, pre = tt._reference_forward(name, "float32")
            want = np.asarray(tt._reference_decode(
                tt._params(name), jnp.asarray(pre["k"], jnp.bfloat16),
                jnp.asarray(pre["v"], jnp.bfloat16), jnp.asarray(toks[:, tt.P:]), cfg, kv_dtype))
            tcfg = tt._port(cfg)
            params = tt.TT.params_from_reference(tt._params(name), "cpu")
            _, tpre = tt.TT.forward(params, {"tokens": torch.from_numpy(toks[:, :tt.P])}, tcfg,
                                    return_cache=True)
            tcache = tt.TK.cache_update(tt.api.init_cache(tcfg, tt.B, tt.MAX, kv_dtype, "cpu"),
                                        tpre["k"].transpose(-3, -2),
                                        tpre["v"].transpose(-3, -2), 0)
            for t in range(tt.STEPS):
                got, tcache = tt.api.decode_step(
                    params, tcache, torch.from_numpy(toks[:, tt.P + t:tt.P + t + 1]),
                    tt.P + t, tcfg)
                err = max(err, float(tt._rel(got[:, 0].numpy(), want[t])))
        rows.append((f"decode_step logits / max, 6 steps, {kind} cache, 3 configs, fp32 compute",
                     "test_decode_steps_match_reference", tt.DECODE_TOL, err))
    return rows


def ssd_rows():
    pallas, seq, chunked = 0.0, 0.0, {"float32": 0.0, "bfloat16": 0.0}
    for shape in tss.SCAN_SHAPES:
        inputs = tss.scan_inputs(*shape[:6])
        y, st = tss.ops.ssd_scan(*tss._t(*inputs), chunk=shape[6])
        for fn, acc in ((lambda a: tss.pallas_ssd_scan(*a, chunk=shape[6], interpret=True),
                         "pallas"), (lambda a: tss.jref.ssd_scan_ref(*a, shape[6]), "seq")):
            wy, wst = fn([jnp.asarray(a) for a in inputs])
            err = max(float(np.max(np.abs(y.numpy() - np.asarray(wy)))),
                      float(np.max(np.abs(st.numpy() - np.asarray(wst)))))
            pallas, seq = (max(pallas, err), seq) if acc == "pallas" else (pallas, max(seq, err))
        x, dt, A, Bm, Cm = tss.scan_inputs(*shape[:6], seed=1)
        for dtype in chunked:
            jd, td = jnp.dtype(dtype), getattr(torch, dtype)
            jy, _ = tss.RS.ssd_chunked(jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(A),
                                       jnp.asarray(Bm, jd), jnp.asarray(Cm, jd), shape[6])
            ty, _ = tss.ref.ssd_chunked(*(torch.from_numpy(a).to(td) if a.ndim == 4
                                          else torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                                        shape[6])
            jy = np.asarray(jy, np.float32)
            chunked[dtype] = max(chunked[dtype], float(np.max(np.abs(ty.float().numpy() - jy))
                                                       / np.abs(jy).max()))
    return [("ops.ssd_scan (plain) vs Pallas (interpret), y and state, 6 shapes",
             "test_plain_scan_matches_pallas_kernel_and_sequential_oracle", tss.SCAN_TOL, pallas),
            ("ops.ssd_scan (plain) vs repro.kernels.ref.ssd_scan_ref",
             "test_plain_scan_matches_pallas_kernel_and_sequential_oracle", tss.SCAN_TOL, seq),
            ("ref.ssd_chunked vs repro.models.ssm.ssd_chunked, fp32, / max |y|",
             "test_chunked_scan_matches_model_chunked_path", tss.CHUNKED_TOL,
             chunked["float32"]),
            ("ref.ssd_chunked vs repro.models.ssm.ssd_chunked, bf16, / max |y|",
             "test_chunked_scan_matches_model_chunked_path", 2 ** -8, chunked["bfloat16"])]


def gmm_rows():
    rows = []
    for dtype in ("float32", "bfloat16"):
        err = 0.0
        for e, c, d, f in tm.GMM_SHAPES:
            rng = np.random.default_rng(0)
            x = rng.normal(size=(e, c, d)).astype(np.float32)
            w = rng.normal(size=(e, d, f)).astype(np.float32)
            jd, td = jnp.dtype(dtype), getattr(torch, dtype)
            want = tm.pallas_gmm(jnp.asarray(x, jd), jnp.asarray(w, jd), block_c=32,
                                 block_f=32, block_d=32, interpret=True)
            got = tm.ops.gmm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td))
            err = max(err, float(np.max(np.abs(got.float().numpy()
                                               - np.asarray(want, np.float32)))))
        rows.append((f"ops.gmm (plain) vs Pallas (interpret), 4 shapes, {dtype}",
                     "test_plain_gmm_matches_pallas_kernel", tm.GMM_TOL[dtype], err))
    return rows


def route_rows():
    """moe routing on the same fp32 inputs: top-k experts, dispatch
    destinations and buffers counted as mismatches (the test asserts 0), the
    weights, aux loss and combine as max |difference|."""
    rng = np.random.default_rng(2)
    n, d, cfg = 40, tm.CFG.d_model, tm.CFG
    x2d = rng.normal(size=(n, d)).astype(np.float32)
    wr = (rng.normal(size=(d, cfg.num_experts)) / np.sqrt(d)).astype(np.float32)
    jw, je, jaux = tm.RM.route(jnp.asarray(x2d), jnp.asarray(wr), cfg)
    tw, te, taux = tm.TM.route(torch.from_numpy(x2d), torch.from_numpy(wr), tss._port(cfg))
    mismatches, err = int(np.sum(te.numpy() != np.asarray(je))), 0.0
    for cap, e_start, e_count in ((tm.RM.capacity_for(n, cfg), 0, 6), (6, 0, 6), (4, 2, 3)):
        jb, jd, jk = tm.RM.dispatch(jnp.asarray(x2d), je, cfg.num_experts, cap, e_start, e_count)
        tb, tdst, tk_ = tm.TM.dispatch(torch.from_numpy(x2d), te, cfg.num_experts, cap, e_start,
                                       e_count)
        mismatches += int(np.sum(tdst.numpy() != np.asarray(jd)))
        mismatches += int(np.sum(tk_.numpy() != np.asarray(jk)))
        mismatches += int(np.sum(tb.numpy() != np.asarray(jb)))
        y = rng.normal(size=tuple(tb.shape)).astype(np.float32)
        want = tm.RM.combine(jnp.asarray(y), jd, jk, jw, n, cfg.num_experts_per_tok)
        got = tm.TM.combine(torch.from_numpy(y), tdst, tk_, tw, n, cfg.num_experts_per_tok)
        err = max(err, float(np.max(np.abs(got.numpy() - np.asarray(want)))))
    err = max(err, float(np.max(np.abs(tw.numpy() - np.asarray(jw)))),
              abs(float(taux) - float(jaux)))
    return [("moe route top_e, dispatch dest/keep/buffers (mismatched elements)",
             "test_route_dispatch_combine_match_reference", 0, mismatches),
            ("moe route top_w, aux loss, combine", "test_route_dispatch_combine_match_reference",
             tm.ROUTE_TOL, err)]


def family_rows():
    """Forward logits / max |logit| (fp32, bf16) and 6 decode steps (fp32)
    of the ssm, moe and hybrid smoke configs against the reference."""
    rows = []
    fams = (("ssm", tss, tss.ref_mamba.SMOKE, tss.RS, tss.TS, 37, 7),
            ("moe", tm, tm.CFG, tm.RM, tm.TM, 16, 4),
            ("hybrid", th, th.CFG, th.RH, th.TH, 37, 9))
    for fam, mod, base, rmod, tmod, n, seed in fams:
        for dtype in ("float32", "bfloat16"):
            cfg = tt.dataclasses.replace(base, compute_dtype=dtype)
            toks = tss.tokens(cfg.vocab_size, n, seed=seed)
            want = jax.jit(lambda p, t: rmod.forward(p, {"tokens": t}, cfg))(
                mod._params(), jnp.asarray(toks))
            want = np.asarray(want[0] if fam == "moe" else want, np.float32)
            got, _ = tss.api.forward(tmod.params_from_reference(mod._params(), "cpu"),
                                     {"tokens": torch.from_numpy(toks)}, tss._port(cfg))
            rows.append((f"{fam} forward logits / max, smoke config, {dtype} compute",
                         "test_forward_matches_reference" if fam != "moe"
                         else "test_forward_and_aux_match_reference",
                         mod.LOGIT_TOL[dtype], float(tss.rel(got.numpy(), want))))
    cfg = tt.dataclasses.replace(th.CFG, compute_dtype="float32", attn_impl="flash_pallas")
    toks = tss.tokens(cfg.vocab_size, 37, seed=9)
    want = np.asarray(jax.jit(lambda p, t: th.RH.forward(p, {"tokens": t}, cfg))(
        th._params(), jnp.asarray(toks)), np.float32)
    got, _ = tss.api.forward(th.TH.params_from_reference(th._params(), "cpu"),
                             {"tokens": torch.from_numpy(toks)}, tss._port(cfg))
    rows.append(("hybrid forward logits / max, smoke config, flash_pallas, float32 compute",
                 "test_forward_under_flash_pallas_matches_reference", th.LOGIT_TOL["float32"],
                 float(tss.rel(got.numpy(), want))))
    for fam, mod, base, rmod, tmod, max_len in (("ssm", tss, tss.ref_mamba.SMOKE, tss.RS,
                                                 tss.TS, 0),
                                                ("hybrid", th, th.CFG, th.RH, th.TH, th.MAX)):
        cfg = tt.dataclasses.replace(base, compute_dtype="float32")
        toks = tss.tokens(cfg.vocab_size, tss.STEPS, seed=8 if fam == "ssm" else 10)
        want = tss.reference_decode(rmod, mod._params(), toks, cfg, max_len)
        got = tss.port_decode(tmod, tmod.params_from_reference(mod._params(), "cpu"), toks,
                              tss._port(cfg), max_len)
        rows.append((f"{fam} decode_step logits / max, 6 steps from a zero cache, fp32",
                     "test_decode_steps_match_reference_and_forward", tss.DECODE_TOL,
                     max(float(tss.rel(g, w)) for g, w in zip(got, want))))
    cfg = tt.dataclasses.replace(tm.CFG, compute_dtype="float32")
    toks = tss.tokens(cfg.vocab_size, tm.P + tm.STEPS, seed=0)
    step = jax.jit(lambda p, c, t, i: tm.RM.decode_step(p, c, t, i, cfg))
    jcache = tm.RM.init_cache(cfg, tm.B, tm.MAX)
    params = tm.TM.params_from_reference(tm._params(), "cpu")
    tcache = tss.api.init_cache(tss._port(cfg), tm.B, tm.MAX, device="cpu")
    err = 0.0
    for t0, t1 in [(0, tm.P)] + [(tm.P + i, tm.P + i + 1) for i in range(tm.STEPS)]:
        jl, jcache = step(tm._params(), jcache, jnp.asarray(toks[:, t0:t1]), t0)
        tl, tcache = tss.api.decode_step(params, tcache, torch.from_numpy(toks[:, t0:t1]), t0,
                                         tss._port(cfg))
        err = max(err, float(tss.rel(tl.numpy(), np.asarray(jl))))
    rows.append(("moe decode_step logits / max, prompt fill + 6 steps, fp32",
                 "test_decode_steps_match_reference", tm.DECODE_TOL, err))
    return rows


def gradient_rows():
    """H8: the kernels' backwards and the families' parameter gradients
    against ``jax.vjp`` of the reference."""
    gmm = max(tm.gmm_grad_err(*shape, strided)
              for shape in tm.GMM_SHAPES[:3] for strided in (False, True))
    scan = max(tss.scan_grad_err(*shape, with_state)
               for shape in tss.SCAN_SHAPES[:2] + tss.SCAN_SHAPES[4:5]
               for with_state in (False, True))
    attn = max(ta.attention_grad_err(*shape) for shape in ta.GRAD_SHAPES)
    vjp = {}
    for fam, mod, port, params, cfg, n, seeds in (
            ("ssm", tss.RS, tss.TS, tss._params(), tss.ref_mamba.SMOKE, 37, (11, 12)),
            ("moe", tm.RM, tm.TM, tm._params(), tm.CFG, 16, (13, 14)),
            ("hybrid", th.RH, th.TH, th._params(),
             tt.dataclasses.replace(th.CFG, attn_impl="flash_pallas"), 37, (15, 16))):
        cfg = tt.dataclasses.replace(cfg, compute_dtype="float32")
        errs = tss.model_vjp(mod, port, params, cfg, tss.tokens(cfg.vocab_size, n, seed=seeds[0]),
                             seeds[1])
        vjp[fam] = max(errs.values())
    return [("ops.gmm dx, dw vs jax.vjp, 3 shapes, contiguous and strided views, fp32, / max",
             "test_gmm_gradient_matches_jax_grad", tm.GMM_TOL["float32"], gmm),
            ("ops.ssd_scan dx, ddt, dA, dB, dC vs jax.vjp, 3 shapes, state cotangent None "
             "or not, fp32, / max(1, max)", "test_scan_gradient_matches_jax_grad",
             tss.GRAD_TOL, scan),
            ("ops.flash_attention dq, dk, dv vs jax.vjp of the model's attention, 4 shapes, fp32",
             "test_gradient_matches_jax_grad", ta.GRAD_TOL, attn)] + [
            (f"{fam} parameter gradients of <logits, ct> vs jax.vjp, smoke config"
             f"{', flash_pallas' if fam == 'hybrid' else ''}, fp32, per leaf / max(1, max)",
             "test_vjp_matches_reference", tss.GRAD_TOL, err) for fam, err in vjp.items()]


def cascade_rows():
    """Records and stats that differ from the reference's (bitwise checks)."""
    mismatches = 0
    for scenario_set in (["paper-use-cases"], ["edge-skus", "lat-0.3ms"], []):
        vecs = tca._joint_vecs(tca.nas.tiny_space(), tca.has.has_space(), 256, seed=21)
        vecs[::2, tca.nas.tiny_space().num_decisions:] = tca.ref_has.baseline_vec(
            tca.ref_has.has_space())
        ref_casc = tca.RefCascade(scenarios=scenario_set)
        port_casc = tca.CascadeBackend(scenarios=scenario_set)
        ref = tca.ref_engine.EvaluationEngine(
            tca.ref_nas.tiny_space(), tca.ref_has.has_space(), tca.ref_proxy.SurrogateAccuracy(),
            tca._rcfg(tca.ref_reward, area_target_mm2=tca.ref_sim.BASELINE_AREA_MM2),
            backend=ref_casc)
        port = tca.port_engine.EvaluationEngine(
            tca.nas.tiny_space(), tca.has.has_space(), tca.proxy.SurrogateAccuracy(),
            tca._rcfg(), backend=port_casc)
        for chunk in np.split(vecs, 4):
            mismatches += sum(g != w for g, w in zip(port.evaluate_batch(chunk),
                                                     ref.evaluate_batch(chunk)))
        mismatches += port_casc.stats.as_dict() != ref_casc.stats.as_dict()
    return [("hw.cascade records and stats, 3 x 256 replayed joint vectors (mismatches)",
             "test_replayed_stream_gives_the_reference_records_and_stats", 0, mismatches)]


def costmodel_rows():
    feats, lat, area, en = tcm.R.generate_dataset(
        tcm.ref_nas.tiny_space(), tcm.ref_has.has_space(), 300, seed=0, include_energy=True)
    fwd = 0.0
    for energy in (False, True):
        p = tcm._ref_params(feats.shape[1], energy)
        want = tcm.R.mlp_forward_all(jax.tree.map(jnp.asarray, p), feats.astype(np.float32))
        got = tcm.T.mlp_forward_all(tcm.T.params_from_reference(p, "cpu"),
                                    torch.from_numpy(feats.astype(np.float32)))
        fwd = max(fwd, max(float(np.max(np.abs(g.numpy() - np.asarray(w)))
                                 / max(1.0, np.abs(np.asarray(w)).max()))
                           for g, w in zip(got, want) if w is not None))
    cfg = tcm.R.CostModelConfig(steps=50, batch=64, dropout=0.0)
    init = tcm.T.init_mlp
    tcm.T.init_mlp = lambda gen, in_dim, c, energy=False, device="cuda": (
        tcm.T.params_from_reference(tcm._ref_params(in_dim, energy, c.seed), device))
    try:
        want, want_m = tcm.R.train(feats, lat, area, cfg, energy_mj=en)
        got, got_m = tcm.T.train(feats, lat, area, tcm.T.CostModelConfig(**vars(cfg)),
                                 energy_mj=en, device="cpu")
    finally:
        tcm.T.init_mlp = init
    params = max(float(np.max(np.abs(g.numpy() - w)) / max(1.0, np.abs(w).max()))
                 for g, w in zip(tcm.tree_leaves(got.params),
                                 tcm.tree_leaves(jax.tree.map(np.asarray, want.params))))
    metrics = max(abs(got_m[k] - w) / abs(w) for k, w in want_m.items())
    return [("costmodel.mlp_forward_all on converted params, 2 and 3 heads, / max(1, max)",
             "test_mlp_forward_all_matches_reference", tcm.FWD_TOL, fwd),
            ("costmodel.train from the reference's init, 50 steps, dropout 0, energy head: "
             "params per leaf / max(1, max)", "test_train_matches_reference_from_its_init",
             tcm.PARAM_TOL, params),
            ("the same: validation metrics, relative", "test_train_matches_reference_from_its_init",
             tcm.METRIC_TOL, metrics)]


def oneshot_rows():
    np_params = to.tree_map(lambda t: t.numpy(), to.TO.init_supernet(0, to.TBASE, device="cpu"))
    ref_params = jax.tree.map(jnp.asarray, np_params)
    tp = to.TO.params_from_reference(np_params, "cpu")
    logits = step = grads = 0.0
    for name in to.DRAWS:
        ks, exps, ops = to._draw(name)
        x, _ = to._inputs()
        want = np.asarray(to._ref_forward(ref_params, jnp.asarray(x), to.BASE, jnp.asarray(ks),
                                          jnp.asarray(exps), jnp.asarray(ops)))
        got = to.TO.supernet_forward(tp, torch.from_numpy(x), to.TBASE, ks, exps, ops).numpy()
        logits = max(logits, float(np.max(np.abs(got - want)) / np.abs(want).max()))
        (_, want_g, want_p), (_, got_g, got_p), _ = to._sgd_step_both(np_params, ref_params,
                                                                       name)
        errs = to.tree_map(lambda g, w: float(np.max(np.abs(g.numpy() - w))
                                               / max(1.0, np.abs(w).max())), got_p, want_p)
        step = max(step, max(to.tree_leaves(errs)))
        grads = max(grads, max(to._grad_errs(got_g, want_g)))
    return [("oneshot.supernet_forward logits, 4 draws (all IBN, all fused, 2 mixed), "
             "small base, / max", "test_supernet_forward_matches_reference", to.LOGIT_TOL,
             logits),
            ("oneshot.train_step params after one SGD step vs jax.value_and_grad, 4 draws, "
             "per leaf / max(1, max)", "test_sgd_step_matches_reference", to.PARAM_TOL, step),
            ("the same step's gradients, per leaf / that leaf's max |gradient|",
             "test_sgd_step_matches_reference", to.GRAD_TOL, grads)]


def train_rows():
    rng = np.random.default_rng(2)
    logits = (3 * rng.normal(size=(3, 7, 41))).astype(np.float32)
    labels = rng.integers(-1, 41, size=(3, 7)).astype(np.int32)
    ce = {}
    for dtype in ("float32", "bfloat16"):
        want = float(ttr.rapi.cross_entropy(jnp.asarray(logits, dtype), jnp.asarray(labels)))
        got = ttr.tapi.cross_entropy(torch.from_numpy(logits).to(getattr(torch, dtype)),
                                     torch.from_numpy(labels)).item()
        ce[dtype] = abs(got - want) / abs(want)
    opt = [max(ttr.optimizer_errs(name)[0].values())
           for name in ("adamw", "adafactor", "rmsprop", "sgd")]
    rows = [("api.cross_entropy with ignored labels, fp32 / bf16 logits, relative",
             "test_cross_entropy_matches_reference", ttr.CE_TOL, max(ce.values())),
            ("adamw / adafactor (a (2, 128, 256) stacked leaf) / rmsprop / sgd, params and "
             "every state leaf after 3 steps on the same gradients, per leaf / max(1, max): "
             + " / ".join(f"{e:.3g}" for e in opt),
             "test_optimizer_matches_reference_after_three_steps", ttr.OPT_TOL, max(opt))]
    remat = max(max(ttr.remat_errs(f, r)[1].values())
                for f in ("dense", "ssm", "moe", "hybrid") for r in ("full", "dots"))
    rows.append(("remat full / dots against none, dense / ssm / moe / hybrid: gradients per "
                 "leaf / that leaf's max", "test_remat_gives_the_gradients_of_none",
                 ttr.REMAT_TOL, remat))
    for variant, (_, _, tol, leaf_tol) in ttr.VARIANTS.items():
        errs = {f: ttr.train_step_errs(f, v) for f, v in ttr.CASES if v == variant}
        loss = max(max(e["loss"]) for e in errs.values())
        grads = max(e["grads"] for e in errs.values())
        moments = max(max(e["mu"], e["nu"]) for e in errs.values())
        fams = "/".join(errs)
        rows.append((f"make_train_step, 3 AdamW steps, {variant}, {fams}: loss, relative",
                     "test_train_step_matches_reference", tol, loss))
        rows.append((f"the same, {variant}: the first step's gradients per leaf / that "
                     "leaf's max", "test_train_step_matches_reference", leaf_tol, grads))
        rows.append((f"the same, {variant}: mu and nu after 3 steps per leaf / that leaf's max",
                     "test_train_step_matches_reference", leaf_tol, moments))
        if variant == "cast_bf16":
            rows.append(("the same, cast_bf16, planted fault (the clip lost on the bf16 "
                         "gradients), its smallest reading: must exceed the limit",
                         "test_train_step_matches_reference", leaf_tol,
                         min(e["control"] for e in errs.values())))
    return rows


def pod_rows():
    """The shape-only init, the pod roofline, the grid and the mesh search
    (mismatches of the bitwise checks; the mesh search's logits)."""
    leaves = counts = flops = 0
    for arch in tr.configs.ARCHS:
        got = tr.tree_paths(tr.steps.abstract_params(tr.configs.get(arch)))
        want = tr.tree_paths(tr.ref_steps.abstract_params(tr.ref_configs.get(arch)))
        leaves += len(got) != len(want)
        leaves += sum((a, tr._sig(x)) != (b, tr._sig(y)) for (a, x), (b, y) in zip(got, want))
        counts += tr.roofline.count_params(tr.configs.get(arch)) != tr._ref_counts(arch)
        for name in tr.SHAPES:
            flops += (np.float64(tr.roofline.model_flops(tr.configs.get(arch), tr.SHAPES[name]))
                      .tobytes() != np.float64(tr.ref_roof.model_flops(
                          tr.ref_configs.get(arch), tr.REF_SHAPES[name])).tobytes())
    records = 0
    space = tr.meshsearch.mesh_space(256)
    hs = [space.to_dict(v) for v in np.ndindex(*space.arity)]
    for arch in tr.MESH_CONFIGS:
        for mode in tr.MODES:
            port = tr.port_hw.PodRooflineBackend(tr.configs.get(arch), tr.SHAPES[mode])
            ref = tr.ref_hw.PodRooflineBackend(tr.ref_configs.get(arch), tr.REF_SHAPES[mode])
            n = ref._param_count()
            ref._param_count = lambda n=n: n
            records += sum(repr(port.evaluate(h)) != repr(ref.evaluate(h)) for h in hs)
    grid_got, grid_want = tsc._port_grid(), tsc._ref_grid()
    grid = sum(tsc._fields(a) != tsc._fields(b) for a, b in zip(grid_got, grid_want))
    feats = max(float(np.max(np.abs(tsc.port.features(a) - tsc.ref.features(b))))
                for a, b in zip(grid_got, grid_want))

    made, saved = {}, {}
    for side, module in (("ref", tms.ref_mesh), ("port", tms.meshsearch)):
        saved[side] = module.PPOController

        class Recorded(saved[side]):
            def __init__(self, *args, _side=side, **kwargs):
                super().__init__(*args, **kwargs)
                made[_side] = self

        module.PPOController = Recorded
    try:
        want = tms.ref_mesh.search_mesh(tms.ref_configs.get("mamba2-370m"),
                                        tms.REF_SHAPES["train_4k"], samples=tms.SAMPLES, seed=0)
        got = tms.meshsearch.search_mesh(tms.configs.get("mamba2-370m"), tms.SHAPES["train_4k"],
                                         samples=tms.SAMPLES, seed=0, device="cpu")
    finally:
        tms.ref_mesh.PPOController = saved["ref"]
        tms.meshsearch.PPOController = saved["port"]
    cfgs = sum(g["config"] != w["config"] for g, w in zip(got.history, want.history))
    recs = sum(repr(g) != repr(w) for g, w in zip(got.history, want.history))
    logits = float(np.max(np.abs(made["port"].logits.numpy() - np.asarray(made["ref"].logits))))
    return [("abstract_params leaves (name, shape, dtype), 10 configs (mismatches); "
             "count_params, 10 configs; model_flops, 10 configs x 4 shapes, bitwise",
             "test_abstract_params_match_eval_shape, "
             "test_count_params_and_model_flops_match_reference", 0, leaves + counts + flops),
            ("PodRooflineBackend records over mesh_space(256), 3 configs x 3 modes x 1080, "
             "bitwise (mismatches)", "test_pod_roofline_records_bitwise_over_the_mesh_space",
             0, records),
            ("scenarios.grid(), 324 scenarios field for field (mismatches); their features",
             "test_grid_matches_reference, test_grid_features_bitwise", 0, grid + feats),
            ("search_mesh(mamba2-370m, train_4k, 96 samples): mismatching configs + records",
             "test_search_mesh_matches_reference", 0, cfgs + recs),
            ("search_mesh: final PPO logits", "test_search_mesh_matches_reference",
             tms.CTRL_TOL, logits)]


def main():
    rows = (convnet_rows() + kernel_rows() + controller_rows() + attention_rows()
            + transformer_rows() + ssd_rows() + gmm_rows() + route_rows() + family_rows()
            + gradient_rows() + cascade_rows() + costmodel_rows() + oneshot_rows()
            + train_rows() + pod_rows())
    print("| Module or kernel | Test | Tolerance | Max error measured | Device |")
    print("|---|---|---|---|---|")
    for what, test, tol, err in rows:
        print(f"| {what} | `{test}` | {tol:g} | {err:.3g} | CPU |")


if __name__ == "__main__":
    main()

"""The port's full-sequence forward and training path against the JAX
package's, on the CPU.

Same numpy inputs from a seed and the reference's weights (carried over
by ``params_from_jax``) go through both packages. Tolerances (fp32):

- loss, schedules, clipping, one AdamW update: rtol 1e-6 / atol 1e-7
  (the same fp32 operations in the same order; only the global norm's
  sum over leaves runs in another order);
- ``Model.forward``: logits rtol/atol 1e-4, hidden and aux 1e-5, as
  ``tests/test_torch_models.py`` holds prefill;
- gradients: rtol 1e-4 / atol 1e-6 (the backward's sums run in another
  order than XLA's);
- after three train steps: losses and metrics rtol 1e-4 / atol 1e-5;
  parameters within atol 2e-5 (2% of AdamW's normalised step, lr =
  1e-3), but for at most one element in 10^4 that must stay within 1e-4:
  where a gradient element is a near-cancelling sum, its rounding moves
  m_hat / sqrt(v_hat), and so that parameter, by a visible share of a
  step (5-14 elements of ~1.3 M, at most 7e-5, in the cases here); the
  moments within GRAD_TOL under the same one-in-10^4 rule;
- checkpoints, ``lm_batches``, ``ChainTask`` and ``SimulatedDecoder``:
  equal.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrain
from repro.configs import get_config as jget_config
from repro.data import ChainTask as JChain
from repro.data import SimulatedDecoder as JSim
from repro.data import lm_batches as jlm_batches
from repro.models import build_model as jbuild
from repro.training import init_opt_state as jinit_opt
from repro.training import learning_rate as jlr
from repro.training import make_loss_fn as jmake_loss
from repro.training import make_train_step as jmake_step
from repro.training.loss import cross_entropy as jce
from repro.training.loss import total_loss as jtotal
from repro.training.optimizer import adamw_update as jadamw
from repro.training.optimizer import clip_by_global_norm as jclip
from repro_torch import config as tconfig
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data import ChainTask, SimulatedDecoder, lm_batches
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build_model
from repro_torch.training import (init_opt_state, learning_rate,
                                  load_checkpoint, make_train_step,
                                  save_checkpoint)
from repro_torch.training.loss import cross_entropy, total_loss
from repro_torch.training.optimizer import (OptState, adamw_update,
                                            clip_by_global_norm)
from repro_torch.training.train_loop import _grads, batch_to, make_loss_fn
from torch_ranks import _one_torch_thread  # noqa: F401

EXACT = dict(rtol=1e-6, atol=1e-7)
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL, PARAM_OUTLIER_ATOL, OUTLIER_SHARE = 2e-5, 1e-4, 1e-4
B, L = 4, 16


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), **tol)


def close_but_few(exp, got, rtol, atol, outlier_atol):
    """Tensors of a dict within rtol/atol, but for at most
    ``OUTLIER_SHARE`` of all their elements, which stay within
    ``outlier_atol``."""
    n = bad = 0
    for k, g in got.items():
        e, g = exp[k].numpy(), g.detach().numpy()
        err = np.abs(e - g)
        assert err.max() <= outlier_atol + rtol * np.abs(e).max(), \
            (k, float(err.max()))
        bad += int((err > atol + rtol * np.abs(e)).sum())
        n += e.size
    assert bad <= OUTLIER_SHARE * n, (bad, n)


def port_cfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(tconfig.ModelConfig)}
    for name, cls in (("moe", tconfig.MoEConfig),
                      ("vision", tconfig.VisionConfig),
                      ("ssm", tconfig.SSMConfig),
                      ("rglru", tconfig.RGLRUConfig)):
        if getattr(jcfg, name) is not None:
            kw[name] = cls(**dataclasses.asdict(getattr(jcfg, name)))
    return tconfig.ModelConfig(**kw)


def port_model(jcfg, jparams):
    cfg = port_cfg(jcfg)
    model = build_model(cfg, torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg))
    return model


ARCHS = ("qwen3-0.6b", "granite-moe-3b-a800m", "internvl2-2b")


@pytest.fixture(scope="module")
def pairs():
    """Reduced fp32 reference model and params (seed 0) of each arch."""
    out = {}
    for arch in ARCHS:
        jcfg = jget_config(arch).reduced().with_overrides(dtype="float32")
        jmodel = jbuild(jcfg, jnp.float32)
        out[arch] = (jcfg, jmodel, jmodel.init(jax.random.PRNGKey(0)))
    return out


def batches(jcfg, n, seed=0, batch=B, seq=L):
    ev = None
    if jcfg.num_evidence_tokens:
        ev = {"num_tokens": jcfg.num_evidence_tokens,
              "dim": jcfg.evidence_dim}
    it = lm_batches(jcfg.vocab_size, batch, seq, seed=seed, evidence=ev)
    return [next(it) for _ in range(n)]


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# loss, schedule, clipping, AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_total_loss_match(masked):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 5, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    # some positions predicted right, so accuracy is not 0
    labels[0, :2] = logits[0, :2].argmax(-1)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32) if masked \
        else None
    tmask = None if mask is None else t(mask)
    jl, jm = jce(logits, labels, mask)
    tl, tm = cross_entropy(t(logits), t(labels), tmask)
    close(jl, tl, EXACT)
    assert set(jm) == set(tm)
    for k in jm:
        close(jm[k], tm[k], EXACT)
    aux = {"moe_lb_loss": np.float32(1.3), "moe_z_loss": np.float32(4.5),
           "moe_drop_frac": np.float32(0.25)}
    for a in ({}, aux):
        jl, jm = jtotal(logits, labels, a, mask, moe_aux_weight=0.02)
        tl, tm = total_loss(t(logits), t(labels),
                            {k: t(v) for k, v in a.items()}, tmask,
                            moe_aux_weight=0.02)
        close(jl, tl, EXACT)
        assert set(jm) == set(tm)
        for k in jm:
            close(jm[k], torch.as_tensor(tm[k]), EXACT)


def test_cross_entropy_empty_mask_divides_by_one():
    logits = np.zeros((1, 3, 4), np.float32)
    labels = np.zeros((1, 3), np.int32)
    mask = np.zeros((1, 3), np.float32)
    jl, _ = jce(logits, labels, mask)
    tl, _ = cross_entropy(t(logits), t(labels), t(mask))
    assert float(tl) == float(jl) == 0.0


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_learning_rate_schedules_match(schedule):
    kw = dict(learning_rate=3e-3, warmup_steps=10, total_steps=110,
              schedule=schedule)
    jc, tc = JTrain(**kw), tconfig.TrainConfig(**kw)
    for s in (0, 1, 5, 10, 11, 37, 60, 109, 110, 150):
        close(jlr(jc, jnp.asarray(s)), learning_rate(tc, torch.tensor(s)),
              EXACT)


def test_clip_by_global_norm_matches():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32) * 5,
            "b": rng.standard_normal(7).astype(np.float32)}
    for max_norm in (1.0, 1e3):
        jg, jn = jclip(tree, max_norm)
        tg, tn = clip_by_global_norm({k: t(v) for k, v in tree.items()},
                                     max_norm)
        close(jn, tn, EXACT)
        for k in tree:
            close(jg[k], tg[k], EXACT)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches(state_dtype):
    """Two AdamW updates on a small tree from a nonzero state: parameters,
    moments (in their own dtype) and metrics."""
    rng = np.random.default_rng(2)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[state_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[state_dtype]
    shapes = {"embed": (6, 4), "scale": (4,), "w": (4, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    kw = dict(learning_rate=1e-2, warmup_steps=1, total_steps=5,
              grad_clip=0.5)
    jc, tc = JTrain(**kw), tconfig.TrainConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jinit_opt(jp, jdt)
    tp = {k: t(v) for k, v in params.items()}
    tst = init_opt_state(tp, tdt)
    for _ in range(2):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        jp, jst, jm = jadamw(jc, jp, grads, jst)
        tp, tst, tm = adamw_update(tc, tp, {k: t(g) for k, g in
                                            grads.items()}, tst)
    assert int(tst.step) == int(jst.step) == 2
    for k in shapes:
        close(jp[k], tp[k], EXACT)
        assert tst.m[k].dtype == tdt and tst.v[k].dtype == tdt
        close(jst.m[k].astype(jnp.float32), tst.m[k], EXACT)
        close(jst.v[k].astype(jnp.float32), tst.v[k], EXACT)
    for k in ("grad_norm", "lr"):
        close(jm[k], tm[k], EXACT)


# ---------------------------------------------------------------------------
# Model.forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(pairs, arch):
    """Logits, hidden states and the MoE aux dict (all three keys for
    granite-moe; none for the dense ones), internvl2-2b with evidence
    ahead of the tokens."""
    jcfg, jmodel, jparams = pairs[arch]
    model = port_model(jcfg, jparams)
    b = batches(jcfg, 1)[0]
    ev = b.get("evidence")
    jl, jh, jaux = jmodel.forward(jparams, jnp.asarray(b["tokens"]),
                                  None if ev is None else jnp.asarray(ev))
    tl, th, taux = model.forward(t(b["tokens"]),
                                 None if ev is None else t(ev))
    assert tl.shape == (B, L + jcfg.num_evidence_tokens, jcfg.vocab_size)
    close(jl, tl, LOGIT_TOL)
    close(jh, th)
    assert set(taux) == set(jaux)
    if jcfg.moe is not None:
        assert set(taux) == {"moe_lb_loss", "moe_z_loss", "moe_drop_frac"}
    for k in jaux:
        close(jaux[k], taux[k])


def test_forward_aux_reduction_over_superblocks_and_tail(pairs):
    """Three MoE layers, under a one-kind pattern (three super-blocks: the
    mean over layers) and under a two-kind one (one super-block of two
    layers summed, plus a tail layer added): the reference's reduction in
    both, which differ."""
    jcfg0 = pairs["granite-moe-3b-a800m"][0]
    x = batches(jcfg0, 1)[0]["tokens"]
    got = []
    for pattern in (("attn",), ("attn", "attn")):
        jcfg = jcfg0.with_overrides(num_layers=3, block_pattern=pattern)
        jmodel = jbuild(jcfg, jnp.float32)
        jparams = jmodel.init(jax.random.PRNGKey(1))
        _, _, jaux = jmodel.forward(jparams, jnp.asarray(x))
        _, _, taux = port_model(jcfg, jparams).forward(t(x))
        assert set(taux) == set(jaux) == {"moe_lb_loss", "moe_z_loss",
                                          "moe_drop_frac"}
        for k in jaux:
            close(jaux[k], taux[k])
        got.append(taux)
    assert float(got[1]["moe_z_loss"]) > 1.5 * float(got[0]["moe_z_loss"])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_gradients_match_and_remat_changes_nothing(pairs, arch):
    """d loss / d every parameter against ``jax.grad`` of the reference's
    loss; the port's with ``remat`` on equal to those with it off."""
    jcfg, jmodel, jparams = pairs[arch]
    b = batches(jcfg, 1, seed=3)[0]
    jgrads, (jmetrics) = jax.grad(
        jmake_loss(jmodel, JTrain(remat=False)), has_aux=True)(
            jparams, jbatch(b))
    jflat = params_from_jax(jax.tree.map(np.asarray, jgrads),
                            port_cfg(jcfg))
    got = {}
    for remat in (False, True):
        model = port_model(jcfg, jparams)
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        loss, metrics = make_loss_fn(model, tconfig.TrainConfig(
            remat=remat))(batch_to(b, "cpu"))
        got[remat] = _grads(loss, params)
        close(jmetrics["loss"], loss.detach(), METRIC_TOL)
    assert set(got[False]) == set(jflat)
    for k, g in got[False].items():
        close(jflat[k], g, GRAD_TOL)
        assert torch.equal(g, got[True][k]), k


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _held_train(pairs, arch, microbatches, n_steps, seed=0):
    jcfg, jmodel, jparams = pairs[arch]
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              microbatches=microbatches)
    jstep = jax.jit(jmake_step(jmodel, JTrain(**kw)))
    jp, jopt = jparams, jinit_opt(jparams)
    model = port_model(jcfg, jparams)
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    opt = init_opt_state(params)
    step = make_train_step(model, tconfig.TrainConfig(**kw))
    for b in batches(jcfg, n_steps, seed=seed):
        jp, jopt, jm = jstep(jp, jopt, jbatch(b))
        params, opt, tm = step(params, opt, batch_to(b, "cpu"))
        assert set(tm) == set(jm)
        for k in jm:
            close(jm[k], torch.as_tensor(tm[k]), METRIC_TOL)
    cfg = port_cfg(jcfg)
    jflat = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    jo = opt_state_from_jax(jax.tree.map(np.asarray, jopt), cfg)
    assert int(opt.step) == int(jo.step) == n_steps
    assert params.keys() == jflat.keys() == opt.m.keys()
    close_but_few(jflat, params, 0.0, PARAM_ATOL, PARAM_OUTLIER_ATOL)
    close_but_few(jo.m, opt.m, GRAD_TOL["rtol"], GRAD_TOL["atol"],
                  PARAM_OUTLIER_ATOL)
    close_but_few(jo.v, opt.v, GRAD_TOL["rtol"], 1e-9, 1e-6)
    return jm, tm


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_three_train_steps_match(pairs, arch, microbatches):
    """Three ``make_train_step`` steps from the same weights and batches:
    every metric of every step, then parameters and both moments."""
    jm, _ = _held_train(pairs, arch, microbatches, 3)
    if arch.startswith("granite"):
        assert "moe_lb_loss" in jm and "moe_drop_frac" in jm


def test_vlm_train_step_with_evidence_matches(pairs):
    """internvl2-2b: evidence rows ahead of the tokens, the loss over the
    text positions only; its vision tower's weights get zero gradients and
    decay as the reference's do."""
    _held_train(pairs, "internvl2-2b", 1, 1)


# ---------------------------------------------------------------------------
# checkpoints, data, CLI
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path, pairs):
    """A model's state dict and an OptState with bf16 moments: dtypes,
    values and step come back; a fresh model loaded from it gives the
    same logits bit for bit."""
    jcfg, _, jparams = pairs["qwen3-0.6b"]
    model = port_model(jcfg, jparams)
    path = os.path.join(tmp_path, "ck", "model")
    save_checkpoint(path, model.state_dict(), step=7)
    fresh = build_model(port_cfg(jcfg), torch.float32, device="cpu", seed=5)
    sd, step = load_checkpoint(path, fresh.state_dict())
    assert step == 7
    fresh.load_state_dict(sd)
    x = t(batches(jcfg, 1)[0]["tokens"])
    assert torch.equal(model.forward(x)[0], fresh.forward(x)[0])

    params = dict(model.named_parameters())
    opt = init_opt_state(params, torch.bfloat16)
    opt.m["embed.table"].normal_()
    opt = OptState(torch.tensor(3, dtype=torch.int32), opt.m, opt.v)
    save_checkpoint(path + "_opt", opt, step=3)
    like = init_opt_state(params, torch.bfloat16)
    back, step = load_checkpoint(path + "_opt", like)
    assert step == 3 and isinstance(back, OptState)
    assert back.step.dtype == torch.int32 and int(back.step) == 3
    for k in params:
        assert back.m[k].dtype == torch.bfloat16
        assert torch.equal(back.m[k], opt.m[k])
        assert torch.equal(back.v[k], opt.v[k])
    with pytest.raises(ValueError):
        load_checkpoint(path + "_opt", {"step": like.step})


def test_synthetic_data_equals_reference():
    """``lm_batches`` (with and without evidence), ``ChainTask`` and
    ``SimulatedDecoder`` give the reference's arrays from the same
    seeds."""
    ev = {"num_tokens": 3, "dim": 8}
    for kw in ({}, {"evidence": ev}, {"base": 5, "max_chain": 6}):
        ours = lm_batches(97, 4, 24, seed=3, **kw)
        ref = jlm_batches(97, 4, 24, seed=3, **kw)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    task, jtask = ChainTask(), JChain()
    for chain in (None, 0, 3, None):
        p1, a1, k1 = task.sample(r1, chain)
        p2, a2, k2 = jtask.sample(r2, chain)
        np.testing.assert_array_equal(p1, p2)
        assert (a1, k1) == (a2, k2)
        assert task.check(p1, np.asarray([a1])) and \
            jtask.check(p2, np.asarray([a2]))
    for tail in ("heavy", "stretched", "light"):
        s1, s2 = SimulatedDecoder(tail=tail, seed=5), JSim(tail=tail, seed=5)
        np.testing.assert_array_equal(s1.sample_difficulty(6),
                                      s2.sample_difficulty(6))
        d1, d2 = s1.trial(0.4, 5), s2.trial(0.4, 5)
        for k in d1:
            np.testing.assert_array_equal(d1[k], d2[k])


def test_train_cli_on_cpu(tmp_path, capsys):
    """``main`` of the training launcher: a step line per logged step, a
    finite history entry per step, a checkpoint a fresh model loads; a
    mesh other than 1x1 is refused."""
    ck = os.path.join(tmp_path, "cli")
    hist = train_cli.main(["--reduced", "--steps", "3", "--batch", "2",
                           "--seq", "16", "--device", "cpu", "--ckpt", ck])
    out = capsys.readouterr().out
    assert out.count("step ") == 3 and "saved" in out
    assert [h["step"] for h in hist] == [0, 1, 2]
    for h in hist:
        assert np.isfinite([h["loss"], h["accuracy"], h["grad_norm"],
                            h["seconds"]]).all()
    cfg = tconfig.ModelConfig(**{
        f.name: getattr(jget_config("qwen3-0.6b").reduced(), f.name)
        for f in dataclasses.fields(tconfig.ModelConfig)}).with_overrides(
            dtype="float32")
    fresh = build_model(cfg, torch.float32, device="cpu", seed=9)
    sd, step = load_checkpoint(ck, fresh.state_dict())
    assert step == 3
    fresh.load_state_dict(sd)
    with pytest.raises(SystemExit, match="item 5"):
        train_cli.main(["--reduced", "--mesh", "2x1", "--device", "cpu"])

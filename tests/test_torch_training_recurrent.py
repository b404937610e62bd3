"""Training the recurrent, hybrid and encoder-decoder families of the port
against the JAX package's, on the CPU: mamba2-780m (SSD blocks),
recurrentgemma-2b (RG-LRU blocks and local attention, remat over its
super-block) and seamless-m4t-large-v2 (encoder-decoder, with evidence
frames into its encoder).

Reduced configs in fp32, the reference's weights carried over by
``params_from_jax`` and ``opt_state_from_jax``, the same seeded
``lm_batches`` on both sides. The tolerances and helpers are
``tests/test_torch_training.py``'s:

- the loss: rtol 1e-4 / atol 1e-5 (METRIC_TOL);
- gradients: rtol 1e-4 / atol 1e-6 (GRAD_TOL). The RG-LRU's log-depth
  scan adds in another tree than ``lax.associative_scan``, and its
  gradient runs back through that tree; over 16 steps both trees have
  depth 4, and the worst element of any gradient (of the SSD block's
  Python loop over chunks against ``lax.scan`` too) reaches half of
  GRAD_TOL. ``torch.clamp_min`` in the RG-LRU's gate passes the whole
  gradient at a tie where ``jnp.maximum`` splits it, but the tie needs
  1 - a^2 = 1e-9 exactly, and sigmoid gates of random weights keep a^2
  at most 0.75 here;
- with ``remat`` on, the port's gradients equal those with it off bit for
  bit (checkpointing recomputes the same fp32 ops in the same order);
- three train steps: every metric at every step within METRIC_TOL, then
  the parameters within atol 2e-5 and both AdamW moments within GRAD_TOL,
  but for at most one element in 10^4 (OUTLIER_SHARE), held within 1e-4
  (moments 1e-6 for v): a near-cancelling gradient element's rounding
  moves m_hat / sqrt(v_hat) by a visible share of a step.

Training runs the ``torch`` impl and launches no kernel, as the
reference's trains on ``xla``. ``launch.train`` trains mamba2 and
recurrentgemma from the CLI; it draws no evidence, so on seamless it
raises, as the reference's forward asserts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrain
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild
from repro.training import init_opt_state as jinit_opt
from repro.training import make_loss_fn as jmake_loss
from repro.training import make_train_step as jmake_step
from repro_torch import config as tconfig
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data import lm_batches
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build_model
from repro_torch.training import init_opt_state, make_train_step
from repro_torch.training.train_loop import _grads, batch_to, make_loss_fn
from test_torch_training import (GRAD_TOL, METRIC_TOL, PARAM_ATOL,
                                 PARAM_OUTLIER_ATOL, close, close_but_few,
                                 jbatch, port_cfg)
from torch_ranks import _one_torch_thread  # noqa: F401

ARCHS = ("mamba2-780m", "recurrentgemma-2b", "seamless-m4t-large-v2")
B, L = 2, 16
STEPS = 3
STEP_KW = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)


def port_model(jcfg, jparams):
    """The port's model with the reference's weights, trainable."""
    cfg = port_cfg(jcfg)
    model = build_model(cfg, torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg))
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return model, params


@pytest.fixture(scope="module")
def pairs():
    """arch -> (jcfg, jmodel, jparams, jitted reference steps by
    microbatches), at reduced() size in fp32, made on first use."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg = jget_config(arch).reduced().with_overrides(
                dtype="float32")
            jmodel = jbuild(jcfg, jnp.float32)
            made[arch] = (jcfg, jmodel, jmodel.init(jax.random.PRNGKey(0)),
                          {})
        return made[arch]
    return get


def batches(jcfg, n, seed=0):
    ev = None
    if jcfg.num_evidence_tokens:
        ev = {"num_tokens": jcfg.num_evidence_tokens,
              "dim": jcfg.evidence_dim}
    it = lm_batches(jcfg.vocab_size, B, L, seed=seed, evidence=ev)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_and_remat_changes_nothing(pairs, arch):
    """d loss / d every parameter against ``jax.grad`` of the reference's
    loss (jitted: it compiles faster than it runs op by op; seamless with
    its evidence frames), every one finite; the port's gradients with
    ``remat`` on equal those with it off, bit for bit."""
    jcfg, jmodel, jparams, _ = pairs(arch)
    b = batches(jcfg, 1, seed=3)[0]
    jgrads, jmetrics = jax.jit(jax.grad(
        jmake_loss(jmodel, JTrain(remat=False)), has_aux=True))(
            jparams, jbatch(b))
    jflat = params_from_jax(jax.tree.map(np.asarray, jgrads),
                            port_cfg(jcfg))
    model, params = port_model(jcfg, jparams)
    got = {}
    for remat in (False, True):
        loss, metrics = make_loss_fn(model, tconfig.TrainConfig(
            remat=remat))(batch_to(b, "cpu"))
        got[remat] = _grads(loss, params)
        close(jmetrics["loss"], loss, METRIC_TOL)
    assert set(got[False]) == set(jflat)
    for k, g in got[False].items():
        assert bool(torch.isfinite(g).all()), k
        close(jflat[k], g, GRAD_TOL)
        assert torch.equal(g, got[True][k]), k


@pytest.mark.parametrize("arch,microbatches",
                         [(a, 1) for a in ARCHS] + [("mamba2-780m", 2)])
def test_three_train_steps_match(pairs, arch, microbatches):
    """Three ``make_train_step`` steps (remat on, as ``TrainConfig`` has
    it) from the same weights and batches against the reference's jitted
    step: every metric of every step, then the parameters and both
    moments."""
    jcfg, jmodel, jparams, jsteps = pairs(arch)
    kw = dict(STEP_KW, microbatches=microbatches)
    if microbatches not in jsteps:
        jsteps[microbatches] = jax.jit(jmake_step(jmodel, JTrain(**kw)))
    jp, jopt = jparams, jinit_opt(jparams)
    model, params = port_model(jcfg, jparams)
    opt = init_opt_state(params)
    step = make_train_step(model, tconfig.TrainConfig(**kw))
    for b in batches(jcfg, STEPS):
        jp, jopt, jm = jsteps[microbatches](jp, jopt, jbatch(b))
        params, opt, tm = step(params, opt, batch_to(b, "cpu"))
        assert set(tm) == set(jm)
        for k in jm:
            close(jm[k], torch.as_tensor(tm[k]), METRIC_TOL)
    cfg = port_cfg(jcfg)
    jflat = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    jo = opt_state_from_jax(jax.tree.map(np.asarray, jopt), cfg)
    assert int(opt.step) == int(jo.step) == STEPS
    assert params.keys() == jflat.keys() == opt.m.keys()
    close_but_few(jflat, params, 0.0, PARAM_ATOL, PARAM_OUTLIER_ATOL)
    close_but_few(jo.m, opt.m, GRAD_TOL["rtol"], GRAD_TOL["atol"],
                  PARAM_OUTLIER_ATOL)
    close_but_few(jo.v, opt.v, GRAD_TOL["rtol"], 1e-9, 1e-6)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_train_cli_on_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch ... --reduced`` trains
    the recurrent and the hybrid model: a step line and a finite history
    entry per step."""
    hist = train_cli.main(["--arch", arch, "--reduced", "--steps", "2",
                           "--batch", "2", "--seq", "16", "--device",
                           "cpu"])
    assert capsys.readouterr().out.count("step ") == 2
    assert [h["step"] for h in hist] == [0, 1]
    for h in hist:
        assert np.isfinite([h["loss"], h["accuracy"], h["grad_norm"],
                            h["seconds"]]).all()


def test_train_cli_refuses_encoder_decoder(pairs):
    """The CLI's batches carry no evidence, so on seamless it raises; the
    reference's loss asserts on the same batch."""
    jcfg, jmodel, jparams, _ = pairs("seamless-m4t-large-v2")
    b = next(lm_batches(jcfg.vocab_size, B, L, seed=0))
    assert "evidence" not in b
    with pytest.raises(AssertionError, match="encoder inputs"):
        jmake_loss(jmodel, JTrain())(jparams, jbatch(b))
    with pytest.raises(ValueError, match="encoder inputs"):
        train_cli.main(["--arch", "seamless-m4t-large-v2", "--reduced",
                        "--steps", "1", "--batch", "2", "--seq", "16",
                        "--device", "cpu"])


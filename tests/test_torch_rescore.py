"""The port's plug-and-play CAMD rescoring (``repro_torch.core.rescore``)
against the JAX package's, on the CPU, at the reduced internvl2-2b that
``tests/test_rescore.py`` builds (and with a narrower evidence width, so
the evidence projection runs), at the reduced granite-moe-3b-a800m, and
at the reduced encoder-decoder seamless-m4t-large-v2, whose evidence
frames go into its encoder (its decoder's logits carry no evidence
offset) and which both packages refuse to rescore without them.

Same numpy inputs from a seed and the reference's weights (carried over
by ``params_from_jax``). Both impls of the port (``torch``; ``cuda``,
whose wrappers run their kernels' plain versions on CPU tensors) against
the reference's ``xla``. Tolerances (fp32): token log-probs, hidden
states, embeddings, scores and their terms rtol/atol 1e-5 (the forward's
hidden states hold 1e-5 in ``tests/test_torch_models.py``; a log-prob is
a difference of a logit and a logsumexp, each 1e-5 here); the round's
``p_star`` within 1e-6, ``stop`` and ``best_uid`` equal, the mixture bias
rtol 2e-4 / atol 1e-4: it is the log of a mixture that adds (1 - sum of
pi_bar) / V, zero in exact arithmetic but a rounding residue in fp32
whose value follows the order of the sum, which moves every entry by up
to ~1e-4 relative (9.3e-5 seen, with scores 5e-7 apart). The
teacher-forced log-probs equal the port's own decode
within 2e-4, the bound ``tests/test_rescore.py`` holds the reference to.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CAMDConfig as JCAMD
from repro.configs import get_config as jget_config
from repro.core import rescore as jrescore
from repro.models import build_model as jbuild
from repro_torch import config as tconfig
from repro_torch.convert import params_from_jax
from repro_torch.core import controller as ctrl
from repro_torch.core import rescore
from repro_torch.models.model import build_model
from torch_ranks import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-4, atol=2e-4)
BIAS_TOL = dict(rtol=2e-4, atol=1e-4)
IMPLS = ("torch", "cuda")


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), **tol)


def port_cfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(tconfig.ModelConfig)}
    if jcfg.moe is not None:
        kw["moe"] = tconfig.MoEConfig(**dataclasses.asdict(jcfg.moe))
    if jcfg.vision is not None:
        kw["vision"] = tconfig.VisionConfig(**dataclasses.asdict(jcfg.vision))
    return tconfig.ModelConfig(**kw)


SETUPS = {
    # as tests/test_rescore.py: evidence width = d, no projection
    "internvl2-2b": dict(),
    # evidence of another width goes through evidence_proj
    "internvl2-2b proj": dict(evidence_dim=96),
    "granite-moe-3b-a800m": dict(),
    # the evidence goes into the encoder; S_align against the frames
    "seamless-m4t-large-v2": dict(),
}


@pytest.fixture(scope="module")
def setups():
    out = {}
    for name, over in SETUPS.items():
        jcfg = jget_config(name.split()[0]).reduced().with_overrides(
            dtype="float32", **over)
        jmodel = jbuild(jcfg, jnp.float32)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        cfg = port_cfg(jcfg)
        model = build_model(cfg, torch.float32, device="cpu")
        model.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, jparams), cfg))
        out[name] = (jcfg, jmodel, jparams, model)
    return out


def inputs(jcfg, K=4, Lp=5, Lc=6, seed=1, evidence=True):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(2, jcfg.vocab_size, Lp).astype(np.int32)
    cands = rng.integers(2, jcfg.vocab_size, (K, Lc)).astype(np.int32)
    mask = np.ones((K, Lc), np.float32)
    mask[K - 1, Lc // 2:] = 0          # a right-padded candidate
    ev = None
    if evidence and jcfg.num_evidence_tokens:
        ev = rng.standard_normal((jcfg.num_evidence_tokens,
                                  jcfg.evidence_dim)).astype(np.float32)
    return prompt, cands, mask, ev


def both(x):
    return (None, None) if x is None else (jnp.asarray(x), t(x))


def refused(jcfg, ev):
    """An encoder-decoder without its encoder inputs: the reference's
    forward asserts, the port's raises."""
    return jcfg.is_encoder_decoder and ev is None


def refuses_both(jfn, tfn):
    with pytest.raises(AssertionError, match="encoder inputs"):
        jfn()
    with pytest.raises(ValueError, match="encoder inputs"):
        tfn()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("evidence", [True, False])
@pytest.mark.parametrize("name", list(SETUPS))
def test_teacher_forced_stats_match(setups, name, evidence, impl):
    jcfg, jmodel, jparams, model = setups[name]
    prompt, cands, mask, ev = inputs(jcfg, evidence=evidence)
    jev, tev = both(ev)

    def jfn():
        return jrescore.teacher_forced_stats(
            jmodel, jparams, jnp.asarray(prompt), jnp.asarray(cands),
            jnp.asarray(mask), jev)

    def tfn():
        return rescore.teacher_forced_stats(model, t(prompt), t(cands),
                                            t(mask), tev, impl=impl)

    if refused(jcfg, ev):
        return refuses_both(jfn, tfn)
    exp, got = jfn(), tfn()
    for e, g in zip(exp, got):
        assert tuple(e.shape) == tuple(g.shape)
        assert not g.requires_grad
        close(e, g)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("evidence", [True, False])
@pytest.mark.parametrize("name", list(SETUPS))
def test_rescore_candidates_match(setups, name, evidence, impl):
    """Scores and every term; with evidence S_align is nonzero on the vlm
    and audio configs, without it zero, as the reference's (seamless
    refuses)."""
    jcfg, jmodel, jparams, model = setups[name]
    prompt, cands, mask, ev = inputs(jcfg, seed=2, evidence=evidence)
    jev, tev = both(ev)
    camd = JCAMD(lambda_g=0.9, lambda_c=0.7)

    def jfn():
        return jrescore.rescore_candidates(
            jmodel, jparams, camd, jnp.asarray(prompt), jnp.asarray(cands),
            jnp.asarray(mask), jev)

    def tfn():
        return rescore.rescore_candidates(
            model, tconfig.CAMDConfig(lambda_g=0.9, lambda_c=0.7), t(prompt),
            t(cands), t(mask), tev, impl=impl)

    if refused(jcfg, ev):
        return refuses_both(jfn, tfn)
    exp, got = jfn(), tfn()
    assert set(got) == set(exp)
    for k in exp:
        close(exp[k], got[k])
    aligned = float(got["s_align"].abs().max())
    assert (aligned > 0) == (ev is not None)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", list(SETUPS))
def test_camd_wrap_matches_over_two_rounds(setups, name, impl):
    """Two checkpoints over rounds of candidates, the state carried: the
    decision (stop, p_star, best_uid, bias, scores, terms) and the state's
    counters, best score and Dirichlet parameters, against the
    reference's; the second round repeats one candidate three times, so
    its cluster grows."""
    jcfg, jmodel, jparams, model = setups[name]
    camd = dict(min_samples=2, delta=0.2, max_clusters=4)
    jc, tc = JCAMD(**camd), tconfig.CAMDConfig(**camd)
    jstate = tstate = None
    for rnd in range(2):
        prompt, cands, mask, ev = inputs(jcfg, seed=5)
        if rnd:
            _, fresh, _, _ = inputs(jcfg, seed=6)
            cands = np.concatenate([np.tile(cands[1:2], (3, 1)), fresh[:1]])
        jev, tev = both(ev)
        uids = np.arange(4, dtype=np.int32) + 10 * rnd
        jstate, jdec = jrescore.camd_wrap(
            jmodel, jparams, jc, jnp.asarray(prompt), jnp.asarray(cands),
            jnp.asarray(mask), jev, state=jstate, uids=jnp.asarray(uids))
        tstate, tdec = rescore.camd_wrap(
            model, tc, t(prompt), t(cands), t(mask), tev, state=tstate,
            uids=t(uids), impl=impl)
        assert bool(tdec["stop"]) == bool(jdec["stop"])
        assert int(tdec["best_uid"]) == int(jdec["best_uid"])
        close(jdec["p_star"], tdec["p_star"], dict(rtol=0, atol=1e-6))
        close(jdec["bias"], tdec["bias"], BIAS_TOL)
        close(jdec["scores"], tdec["scores"])
        for k in jdec["terms"]:
            close(jdec["terms"][k], tdec["terms"][k])
        assert int(tstate.k_t[0]) == int(jstate.k_t)
        assert int(tstate.rounds[0]) == int(jstate.rounds)
        assert int(tstate.tokens_spent[0]) == int(jstate.tokens_spent)
        close(jstate.best_score, tstate.best_score[0])
        close(jstate.alpha, tstate.alpha[0])


def test_camd_wrap_identical_candidates_stop(setups):
    """As ``tests/test_rescore.py``: identical candidates make one cluster
    and a coverage stop; the best uid is a real candidate and the bias
    spans the vocabulary."""
    jcfg, _, _, model = setups["internvl2-2b"]
    camd = tconfig.CAMDConfig(min_samples=2, delta=0.2, max_clusters=4)
    prompt, cands, _, _ = inputs(jcfg, K=3, Lc=5, seed=3, evidence=False)
    cands = np.tile(cands[:1], (3, 1))
    state, dec = rescore.camd_wrap(model, camd, t(prompt), t(cands),
                                   torch.ones(3, 5))
    assert isinstance(state, ctrl.CAMDState) and state.k_t.shape == (1,)
    assert bool(dec["stop"]) and float(dec["p_star"]) > 0.8
    assert 0 <= int(dec["best_uid"]) < 3
    assert dec["bias"].shape == (jcfg.vocab_size,)


@pytest.mark.parametrize("name", ["internvl2-2b", "granite-moe-3b-a800m"])
def test_teacher_forced_logprobs_match_decode(setups, name):
    """The teacher-forced log-probs of a candidate equal those of the
    port's prefill and step-by-step decode of the same sequence."""
    jcfg, _, _, model = setups[name]
    prompt, cands, _, _ = inputs(jcfg, K=1, Lp=6, Lc=4, seed=4,
                                 evidence=False)
    tlp, _, _ = rescore.teacher_forced_stats(model, t(prompt), t(cands),
                                             torch.ones(1, 4))
    with torch.no_grad():
        cache = model.make_cache(1, 16)
        cur, _, cache = model.prefill(t(prompt)[None], cache)
        lps = []
        for j in range(4):
            lps.append(torch.log_softmax(cur.float(), -1)[0, cands[0, j]])
            cur, _, cache = model.decode_step(t(cands[:, j]), cache)
    close(torch.stack(lps).numpy(), tlp[0], DECODE_TOL)

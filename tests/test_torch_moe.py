"""The port's MoE path against the JAX package's, on the CPU.

Same numpy inputs from a seed, and the reference's weights carried over
(``params_from_jax`` for whole models), go through both packages.

- K5's plain versions against the reference's oracles
  (``repro.kernels.ref``) on the sweep shapes of
  ``tests/test_kernels_moe.py``: dispatch bit for bit, combine within
  rtol 1e-5 / atol 1e-6 (sums of k products in another order). The combine
  is also held against the Pallas kernel in interpret mode. The dispatch
  cannot be: under the installed jax its Pallas kernel raises while
  tracing (``pl.load``, fault R1 in ROADMAP.md).
- ``moe_apply`` / ``moe_apply_dense`` against the reference's: output and
  router losses within 1e-5 (fp32; the dispatch and combine move rows
  where the reference multiplies one-hot tables, so only the combine's
  summation order differs), dropped share equal. One case binds the
  capacity, so tokens really drop.
- The reduced granite-moe-3b-a800m: prefill and decode logits within
  1e-4, as ``tests/test_torch_models.py``; greedy and injected-noise CAMD
  streams of the JAX ``paged`` engine and the port's ``paged_cuda`` equal
  token for token, also where bucket padding and grouping decide which
  tokens drop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import CAMDConfig as JCAMD
from repro.config import PagedKVConfig as JPaged
from repro.config import SamplingConfig as JSampling
from repro.configs import get_config as jget_config
from repro.kernels import ref as jref
from repro.kernels.moe_dispatch import moe_combine as pallas_combine
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro_torch import config as tconfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServeEngine
from torch_ranks import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
COMBINE_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def port_cfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(tconfig.ModelConfig)}
    kw["moe"] = tconfig.MoEConfig(**dataclasses.asdict(jcfg.moe))
    return tconfig.ModelConfig(**kw)


def granite_cfg(**moe):
    """The reduced granite (2 layers, d 256, 4 experts top-2, expert
    d_ff 128), fp32, with MoE fields overridden."""
    jcfg = jget_config("granite-moe-3b-a800m").reduced().with_overrides(
        dtype="float32")
    return jcfg.with_overrides(moe=dataclasses.replace(jcfg.moe, **moe))


def _pair(jcfg):
    jmodel = jbuild(jcfg, jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    model = build_model(cfg, torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams),
                                          cfg))
    return jcfg, jmodel, jparams, model


@pytest.fixture(scope="module")
def granite():
    """Dropless (the reduced config's capacity factor 4.0)."""
    return _pair(granite_cfg())


@pytest.fixture(scope="module")
def granite_tight():
    """Capacity factor 1.0: expert capacity binds in prefill buckets."""
    return _pair(granite_cfg(capacity_factor=1.0))


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


# ---------------------------------------------------------------------------
# K5's plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G,g,E,C", [(2, 8, 4, 4), (1, 32, 8, 8),
                                     (3, 16, 6, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_plain_matches_reference(G, g, E, C, dtype):
    """Against the oracle only: the Pallas dispatch kernel fails to trace
    under the installed jax (R1)."""
    rng = np.random.default_rng(G * 100 + E)
    x = rng.standard_normal((G, g, 16)).astype(np.float32)
    idx = rng.integers(-1, g, (G, E, C)).astype(np.int32)
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    exp = np.asarray(jref.moe_dispatch_ref(jnp.asarray(idx), jx), np.float32)
    tx = t(x, TDT[dtype])
    out = ref.moe_dispatch_ref(t(idx), tx)
    assert out.dtype == TDT[dtype]
    np.testing.assert_array_equal(exp, out.float().numpy())
    assert torch.equal(ops.moe_dispatch(t(idx), tx), out)


@pytest.mark.parametrize("G,g,E,C,k", [(2, 8, 4, 4, 2), (1, 16, 6, 3, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_plain_matches_reference(G, g, E, C, k, dtype):
    rng = np.random.default_rng(G + k)
    slot = rng.integers(-1, E * C, (G, g, k)).astype(np.int32)
    gates = rng.uniform(size=(G, g, k)).astype(np.float32)
    eo = rng.standard_normal((G, E, C, 16)).astype(np.float32)
    jeo = jnp.asarray(eo).astype(jnp.dtype(dtype))
    out = ref.moe_combine_ref(t(slot), t(gates), t(eo, TDT[dtype]))
    assert out.dtype == torch.float32
    for exp in (jref.moe_combine_ref(jnp.asarray(slot), jnp.asarray(gates),
                                     jeo),
                pallas_combine(jnp.asarray(slot), jnp.asarray(gates), jeo,
                               interpret=True)):
        np.testing.assert_allclose(np.asarray(exp), out.numpy(),
                                   **COMBINE_TOL)
    assert torch.equal(ops.moe_combine(t(slot), t(gates), t(eo, TDT[dtype])),
                       out)


def test_dispatch_then_combine_roundtrip_identity():
    """Dispatch then combine with unit gates gives back every routed row
    (the reference's roundtrip test, on the port's plain versions)."""
    G, g, d, E, C = 1, 8, 4, 4, 2
    x = torch.arange(G * g * d, dtype=torch.float32).reshape(G, g, d)
    idx = torch.full((G, E, C), -1, dtype=torch.int32)
    slot = torch.full((G, g, 1), -1, dtype=torch.int32)
    for tok in range(g):
        e, c = tok % E, tok // E
        idx[0, e, c] = tok
        slot[0, tok, 0] = e * C + c
    back = ref.moe_combine_ref(slot, torch.ones(G, g, 1),
                               ref.moe_dispatch_ref(idx, x))
    assert torch.equal(back, x)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

def _moe_pair(jcfg, seed=0, dtype=torch.float32):
    """The reference's fp32 MoE params and the port's module holding them
    in ``dtype`` (the router stays fp32)."""
    p = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    cfg = port_cfg(jcfg)
    m = tmoe.MoE(cfg, dtype=dtype, device="cpu")
    sd = {"router.kernel": p["router"]["kernel"], "w_gate": p["w_gate"],
          "w_up": p["w_up"], "w_down": p["w_down"]}
    if "shared" in p:
        for name in ("w_gate", "w_up", "w_down"):
            sd[f"shared.{name}.kernel"] = p["shared"][name]["kernel"]
    m.load_state_dict({k: t(v) for k, v in sd.items()})
    return p, cfg, m


CASES = {   # T tokens, moe overrides
    "dropless": (40, {}),
    "groups_padded": (300, dict(group_size=128)),   # 3 groups, 84 pad rows
    "shared_expert": (50, dict(num_shared_experts=1)),
    "capacity_binds": (300, dict(capacity_factor=1.0, group_size=128)),
}


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_reference(case, impl):
    T, overrides = CASES[case]
    jcfg = granite_cfg(**overrides)
    p, cfg, m = _moe_pair(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    exp, jaux = jmoe.moe_apply(p, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        out, routing = tmoe.moe_apply(m, cfg, t(x).reshape(2, T // 2, -1),
                                      impl=impl)
        aux = tmoe.moe_aux(*routing)
    np.testing.assert_allclose(np.asarray(exp), out.reshape(T, -1).numpy(),
                               **TOL)
    assert set(aux) == set(jaux)
    for name in aux:
        np.testing.assert_allclose(float(jaux[name]), float(aux[name]), **TOL)
    drop = float(jaux["moe_drop_frac"])
    assert (drop > 0) == (case == "capacity_binds")
    assert float(aux["moe_drop_frac"]) == drop
    with torch.inference_mode():
        dense = tmoe.moe_apply_dense(m, cfg, t(x))
    np.testing.assert_allclose(
        np.asarray(jmoe.moe_apply_dense(p, jcfg, jnp.asarray(x))),
        dense.numpy(), **TOL)
    if drop == 0:
        np.testing.assert_allclose(dense.numpy(), out.reshape(T, -1).numpy(),
                                   **TOL)


@pytest.mark.parametrize("case", ["dropless", "capacity_binds"])
def test_bf16_moe_apply_matches_reference(case):
    """Divergence D1, pinned: in bf16 the port's combine sums in fp32 with
    fp32 gates and casts to bf16 once (K5b and its plain version), where
    the reference's combine einsum runs in bf16. Same bf16 weights (router
    fp32 on both sides) and inputs: outputs within the port's bf16
    tolerance, 2e-2 + 2e-2 |ref|, the same tokens dropped, and the port's
    output no farther from the fp32 output than the reference's."""
    T, overrides = CASES[case]
    jcfg = granite_cfg(**overrides)
    p, cfg, m = _moe_pair(jcfg, dtype=torch.bfloat16)
    assert m.w_down.dtype == torch.bfloat16
    assert m.router.kernel.dtype == torch.float32
    pb = {k: v if k == "router" else
          jax.tree.map(lambda a: a.astype(jnp.bfloat16), v)
          for k, v in p.items()}
    x = np.random.default_rng(1).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    exp, jaux = jmoe.moe_apply(pb, jcfg, jnp.asarray(x, jnp.bfloat16))
    assert exp.dtype == jnp.bfloat16
    with torch.inference_mode():
        out, routing = tmoe.moe_apply(m, cfg, t(x, torch.bfloat16),
                                      impl="torch")
        aux = tmoe.moe_aux(*routing)
    assert out.dtype == torch.bfloat16
    exp = np.asarray(exp, np.float32)
    out = out.float().numpy()
    np.testing.assert_allclose(exp, out, rtol=2e-2, atol=2e-2)
    drop = float(jaux["moe_drop_frac"])
    assert (drop > 0) == (case == "capacity_binds")
    assert float(aux["moe_drop_frac"]) == drop
    # the fp32 layer on the same bf16-rounded weights and inputs
    f32 = {k: jax.tree.map(lambda a: a.astype(jnp.float32), v)
           for k, v in pb.items()}
    full, _ = jmoe.moe_apply(f32, jcfg, jnp.asarray(
        jnp.asarray(x, jnp.bfloat16), jnp.float32))
    full = np.asarray(full)
    assert np.abs(out - full).mean() <= np.abs(exp - full).mean()


def test_cuda_impl_hands_the_kernels_contiguous_tensors(monkeypatch):
    """The kernel wrappers refuse strided tensors on the card, and on CPU
    tensors they run the plain versions without looking: check here what
    ``moe_apply`` hands them, at several groups and at one."""
    jcfg = granite_cfg(group_size=128)
    _, cfg, m = _moe_pair(jcfg)
    seen = []

    def spy(name):
        real = getattr(ops, name)

        def wrapper(*args):
            seen.append((name, [a.is_contiguous() for a in args]))
            return real(*args)
        return wrapper

    for name in ("moe_dispatch", "moe_combine"):
        monkeypatch.setattr(ops, name, spy(name))
    for T in (300, 6):
        x = torch.randn(T, cfg.d_model, generator=torch.Generator()
                        .manual_seed(T))
        with torch.inference_mode():
            tmoe.moe_apply(m, cfg, x, impl="cuda")
    assert [n for n, _ in seen] == ["moe_dispatch", "moe_combine"] * 2
    assert all(all(flags) for _, flags in seen), seen


def test_dispatch_tables_priority_is_choice_major():
    """Every first choice outranks every second choice: with capacity 1,
    expert 0 goes to the first token whose FIRST choice it is, though an
    earlier token named it second."""
    gate_idx = torch.tensor([[[1, 0], [0, 1], [0, 2]]])    # (G 1, g 3, k 2)
    idx, slot, keep = tmoe.dispatch_tables(gate_idx, 3, 1)
    assert idx.tolist() == [[[1], [0], [2]]]
    assert slot.tolist() == [[[1, -1], [0, -1], [-1, 2]]]
    assert keep.tolist() == [[[True, False], [True, False], [False, True]]]
    # the kernels take contiguous tables, also with several groups
    idx, slot, _ = tmoe.dispatch_tables(gate_idx.expand(2, 3, 2), 3, 1)
    assert idx.is_contiguous() and slot.is_contiguous()
    assert idx.dtype == slot.dtype == torch.int32


def test_params_from_jax_covers_moe_leaves(granite):
    jcfg, _, jparams, model = granite
    sd = params_from_jax(jax.tree.map(np.asarray, jparams), port_cfg(jcfg))
    assert set(sd) == set(model.state_dict())
    for i in range(jcfg.num_layers):
        for name in ("router.kernel", "w_gate", "w_up", "w_down"):
            assert f"layers.{i}.moe.{name}" in sd
        assert f"layers.{i}.mlp.w_gate.kernel" not in sd
    np.testing.assert_array_equal(
        np.asarray(jparams["super"][0]["moe"]["w_down"][1]),
        sd["layers.1.moe.w_down"].numpy())
    assert model.layers[0].moe.router.kernel.dtype == torch.float32


# ---------------------------------------------------------------------------
# the reduced granite model
# ---------------------------------------------------------------------------

def record_drops(monkeypatch):
    """The dropped share of every MoE call the port's model makes from
    here on."""
    from repro_torch.models import transformer
    drops = []

    def recording(*args, **kw):
        out, routing = tmoe.moe_apply(*args, **kw)
        drops.append(float(tmoe.moe_aux(*routing)["moe_drop_frac"]))
        return out, routing

    monkeypatch.setattr(transformer, "moe_apply", recording)
    return drops


def close(a, b, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               b.detach().float().numpy(), **tol)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_granite_prefill_and_decode_match(granite, impl):
    jcfg, jmodel, jparams, model = granite
    jimpl = {"torch": "xla", "cuda": "pallas"}[impl]
    rng = np.random.default_rng(2)
    B, L, S = 2, 13, 32
    toks = rng.integers(2, jcfg.vocab_size, (B, L)).astype(np.int32)
    jl, jh, jc = jmodel.prefill(jparams, jnp.asarray(toks),
                                jmodel.make_cache(B, S), impl=jimpl)
    with torch.inference_mode():
        tl, th, tc = model.prefill(t(toks, torch.long), model.make_cache(B, S),
                                   impl=impl)
    close(jl, tl)
    close(jh, th)
    for _ in range(3):
        tok = rng.integers(2, jcfg.vocab_size, B).astype(np.int32)
        jl, jh, jc = jmodel.decode_step(jparams, jnp.asarray(tok), jc,
                                        impl=jimpl)
        with torch.inference_mode():
            tl, th, tc = model.decode_step(t(tok, torch.long), tc, impl=impl)
        close(jl, tl)
        close(jh, th)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_granite_bucketed_prefill_with_drops_matches(granite_tight, impl,
                                                     monkeypatch):
    """A right-padded bucket whose tokens overflow expert capacity: the
    pad rows route and take capacity too, so they must carry the same
    hidden states as the reference's plain path on both impls."""
    jcfg, jmodel, jparams, model = granite_tight
    drops = record_drops(monkeypatch)
    rng = np.random.default_rng(3)
    lens = np.array([5, 16, 11, 16], np.int32)
    toks = rng.integers(2, jcfg.vocab_size, (4, 16)).astype(np.int32)
    jl, jh, _ = jmodel.prefill(jparams, jnp.asarray(toks),
                               jmodel.make_cache(4, 32),
                               lengths=jnp.asarray(lens))
    with torch.inference_mode():
        tl, th, _ = model.prefill(t(toks, torch.long),
                                  model.make_cache(4, 32), impl=impl,
                                  lengths=t(lens))
    close(jl, tl)
    close(jh, th)
    assert len(drops) == jcfg.num_layers and max(drops) > 0


# ---------------------------------------------------------------------------
# engine streams
# ---------------------------------------------------------------------------

class ReferenceNoise:
    """The reference engine's Gumbel draws (its fused macro-step keys), as
    the port's noise source (see tests/test_torch_engine_camd.py)."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)
        self.decode_key = jax.random.fold_in(jax.random.PRNGKey(seed),
                                             0x6d6163)

    @staticmethod
    def _gumbel(key, shape):
        return torch.from_numpy(np.array(jax.random.gumbel(key, shape,
                                                           jnp.float32)))

    def first(self, n, vocab):
        self.key, *keys = jax.random.split(self.key, n + 1)
        return torch.cat([self._gumbel(k, (1, vocab)) for k in keys])

    def step(self, t_, batch, vocab):
        return self._gumbel(jax.random.fold_in(self.decode_key, t_),
                            (batch, vocab))


CAMD = dict(samples_per_round=2, max_rounds=3, min_samples=2, max_clusters=8)


def _serve(make, req_cls, cfg, mode, **kw):
    """Prompts of 6, 9 and 6 tokens share a 16-token bucket of 4 rows (one
    a dummy row), the 20-token one a 32-token bucket of its own."""
    eng = make(slots=6, cache_len=64, mode=mode, n_candidates=3,
               max_new_tokens=8, eos_id=cfg.vocab_size, seed=0, macro_steps=8,
               **kw)
    rng = np.random.default_rng(1)
    for i, n in enumerate((6, 9, 6, 20)):
        eng.submit(req_cls(uid=i, prompt=rng.integers(
            2, cfg.vocab_size, n).astype(np.int32)))
    with torch.inference_mode():
        return sorted(eng.run(), key=lambda r: r.uid), eng


@pytest.mark.parametrize("mode,tight", [("greedy", False), ("greedy", True),
                                        ("camd", True)])
def test_streams_equal_reference(granite, granite_tight, mode, tight,
                                 monkeypatch):
    jcfg, jmodel, jparams, model = granite_tight if tight else granite
    drops = record_drops(monkeypatch)
    exp, jeng = _serve(
        lambda **kw: JEngine(jmodel, jparams, impl="paged",
                             paged_kv=JPaged(page_size=8),
                             sampling=JSampling(max_new_tokens=8,
                                                temperature=0.8),
                             camd=JCAMD(**CAMD), **kw),
        JRequest, jcfg, mode)
    out, eng = _serve(
        lambda **kw: ServeEngine(
            model, impl="paged_cuda",
            paged_kv=tconfig.PagedKVConfig(page_size=8),
            sampling=tconfig.SamplingConfig(max_new_tokens=8,
                                            temperature=0.8),
            camd=tconfig.CAMDConfig(**CAMD),
            noise=ReferenceNoise(0) if mode == "camd" else None, **kw),
        Request, jcfg, mode)
    assert len(out) == len(exp) == 4
    for a, b in zip(exp, out):
        assert (a.n_candidates, a.rounds, a.tokens_spent) == \
            (b.n_candidates, b.rounds, b.tokens_spent)
        np.testing.assert_array_equal(np.asarray(a.tokens), b.tokens)
        assert [c["tokens"].tolist() for c in a.candidates] == \
            [c["tokens"].tolist() for c in b.candidates]
    assert (eng.total_steps, eng.macro_launches, eng.host_syncs) == \
        (jeng.total_steps, jeng.macro_launches, jeng.host_syncs)
    eng.pool.check()
    assert eng.pool.in_use == 0
    assert (max(drops) > 0) == tight     # the tight runs really drop

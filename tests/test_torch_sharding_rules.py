"""The port's sharding rule table against the JAX package's, spec for spec.

``repro_torch.distributed.sharding`` reads the port's trees: the flat
state dict of ``convert.params_from_jax`` (layers unstacked) and the
port's flat cache dicts (each kind's layers stacked on axis 0). The
reference's rules run on its own trees (``jax.eval_shape``, nothing
allocated), and its specs are carried onto the port's names by the same
walk ``params_from_jax`` makes (``convert.flat_from_jax`` over object
arrays of per-layer specs), with the stacked leading axis dropped. For
every config of the port, at full and reduced width, and the meshes
{data 16, model 16}, {pod 2, data 16, model 16}, {data 4} and {data 3}
(fake meshes of shape only), every parameter leaf, optimizer moment,
serving parameter, cache leaf (dense, paged with int8 scales, recurrent,
encoder-decoder, at two batch and length shapes) and ``INPUT_SHAPES``
batch gets the reference's spec. A reference spec is padded with None
to the leaf's rank: the port writes one entry per dim.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import INPUT_SHAPES as J_INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jshd
from repro.models import build_model as jbuild_model
from repro.training.optimizer import init_opt_state as jinit_opt_state
from repro_torch.config import INPUT_SHAPES, SSM
from repro_torch.configs import get_config
from repro_torch.convert import flat_from_jax
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import (make_local_mesh, make_production_mesh,
                                     make_serve_mesh)
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import OptState
from torch_ranks import _one_torch_thread  # noqa: F401

ARCHS = ["qwen3-0.6b", "llava-1.5-7b", "granite-moe-3b-a800m",
         "internvl2-2b", "qwen2.5-32b", "yi-34b", "granite-34b",
         "mamba2-780m", "recurrentgemma-2b", "seamless-m4t-large-v2"]


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = [_FakeMesh({"data": 16, "model": 16}),
          _FakeMesh({"pod": 2, "data": 16, "model": 16}),
          _FakeMesh({"data": 4}), _FakeMesh({"data": 3})]
STACKS = ("super", "enc_super", "dec_super")


def _pad(spec, ndim):
    """A reference PartitionSpec as the port writes it: one entry a dim."""
    return tuple(spec) + (None,) * (ndim - len(spec))


def _cfgs(arch, reduced):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    return jcfg, tcfg


def _obj(value, n=None):
    """A 0-d object array holding ``value`` (or ``n`` copies of it)."""
    a = np.empty(() if n is None else (n,), object)
    if n is None:
        a[()] = value
    else:
        for i in range(n):
            a[i] = value
    return a


def _ref_to_port(shapes, specs, tcfg):
    """The reference's param specs under the port's names, each the spec
    of one (unstacked) layer's leaf; also the leaves' shapes there."""
    stacked = []

    def spec_leaf(path, leaf, spec):
        spec = _pad(spec, len(leaf.shape))
        if getattr(path[0], "key", None) in STACKS:
            stacked.append((spec, leaf.shape))
            return _obj(spec[1:], leaf.shape[0])
        return _obj(spec)

    spec_tree = jax.tree_util.tree_map_with_path(spec_leaf, shapes, specs)
    shape_tree = jax.tree.map(
        lambda leaf: np.broadcast_to(np.zeros((), np.int8), leaf.shape),
        shapes)
    flat_specs = flat_from_jax(spec_tree, tcfg)
    flat_shapes = flat_from_jax(shape_tree, tcfg)
    return ({k: v[()] if isinstance(v, np.ndarray) else v
             for k, v in flat_specs.items()},
            {k: v.shape for k, v in flat_shapes.items()}, stacked)


@pytest.fixture(scope="module", params=[(a, r) for a in ARCHS
                                        for r in (False, True)],
                ids=lambda p: f"{p[0]}-{'reduced' if p[1] else 'full'}")
def params_case(request):
    arch, reduced = request.param
    jcfg, tcfg = _cfgs(arch, reduced)
    shapes = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    return jcfg, tcfg, shapes


def test_param_and_opt_specs_equal_reference(params_case):
    """Every parameter leaf ``params_from_jax`` carries, under every mesh:
    the port's ``param_specs`` on the port's unstacked leaf equals the
    reference's on its stacked one with the layer axis dropped (which the
    reference never shards); ``opt_state_specs`` mirrors it and
    ``serve_param_specs`` replicates without a model axis and drops FSDP
    with one."""
    jcfg, tcfg, shapes = params_case
    opt = jax.eval_shape(jinit_opt_state, shapes)
    for mesh in MESHES:
        want, port_shapes, stacked = _ref_to_port(
            shapes, jshd.param_specs(jcfg, shapes, mesh), tcfg)
        assert all(s[0] is None for s, _ in stacked)
        got = shd.param_specs(tcfg, port_shapes, mesh)
        assert got == want
        if "model" in mesh.shape:       # not all replicated
            assert any(any(a is not None for a in s) for s in got.values())
        o = shd.opt_state_specs(tcfg, OptState(step=(), m=port_shapes,
                                               v=port_shapes), mesh)
        jo = jshd.opt_state_specs(jcfg, opt, mesh)
        assert o.step == _pad(jo.step, 0)
        assert o.m == _ref_to_port(shapes, jo.m, tcfg)[0] == o.v
        sv = shd.serve_param_specs(tcfg, port_shapes, mesh)
        ref_sv = jshd.serve_param_specs(jcfg, shapes, mesh)
        assert sv == _ref_to_port(shapes, ref_sv, tcfg)[0]


def test_port_state_dict_has_these_leaves():
    """At reduced width the port's models are built for real: the names
    and shapes the rule table was given above are their state dicts'."""
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch, True)
        shapes = jax.eval_shape(jbuild_model(jcfg).init,
                                jax.random.PRNGKey(0))
        _, port_shapes, _ = _ref_to_port(
            shapes, jshd.param_specs(jcfg, shapes, MESHES[0]), tcfg)
        model = build_model(tcfg, torch.float32, device="cpu")
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
            == port_shapes, arch


def _ref_cache_specs(jcfg, cache, mesh):
    """The reference's cache specs carried onto the port's flat leaves:
    {port leaf: set of per-layer specs} (layer axis dropped where the
    reference stacks), and the unstacked leaves' specs as they are."""
    specs = jshd.cache_specs(jcfg, cache, mesh)
    pat = jcfg.block_pattern
    n_super = jcfg.num_layers // len(pat)
    out = {}

    def put(name, spec):
        out.setdefault(name, set()).add(spec)

    def walk(path, leaf, spec):
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        spec = _pad(spec, len(leaf.shape))
        name = keys[-1]
        if keys[0] in ("pos", "block_table"):
            put(name, spec)
            return
        if keys[0] in ("self", "cross_k", "cross_v"):
            assert spec[0] is None
            put(name, (None,) + spec[1:])
            return
        if keys[0] == "super":
            kind = pat[keys[1]]
            assert spec[0] is None
            per_layer = spec[1:]
        else:                                       # "tail"
            kind = jcfg.layer_kinds[n_super * len(pat) + keys[1]]
            per_layer = spec
        if name == "conv":
            name = "ssm_conv" if kind == SSM else "rglru_conv"
        put(name, (None,) + per_layer)

    jax.tree_util.tree_map_with_path(walk, cache, specs)
    return out


CACHE_SHAPES = [(128, 32768), (8, 288)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True],
                         ids=["full", "reduced"])
def test_cache_specs_equal_reference(arch, reduced):
    """Every leaf of the dense cache and, for the pageable configs, the
    paged one (int8 pools: values and scales), at the decode_32k shape
    (128 x 32768) and a serving shape (8 x 288), pools of B * S / 16 and
    one more page: the port's spec of each flat leaf equals the
    reference's per-layer spec of every layer it stacks."""
    jcfg, tcfg = _cfgs(arch, reduced)
    jmodel = jbuild_model(jcfg)
    for B, S in CACHE_SHAPES:
        cases = [(jax.eval_shape(lambda: jmodel.make_cache(B, S)),
                  (encdec_lib if tcfg.is_encoder_decoder else tf_lib)
                  .make_cache(tcfg, B, S, torch.float32, "meta"))]
        if jmodel.has_pageable_layers and not tcfg.is_encoder_decoder:
            for P in (B * S // 16, B * S // 16 + 1):
                cases.append((
                    jax.eval_shape(lambda: jmodel.make_paged_cache(
                        B, S, page_size=16, num_pages=P, kv_dtype="int8")),
                    tf_lib.make_paged_cache(tcfg, B, S, torch.float32, 16, P,
                                            kv_dtype="int8", device="meta")))
        for jcache, tcache in cases:
            for mesh in MESHES:
                want = _ref_cache_specs(jcfg, jcache, mesh)
                got = shd.cache_specs(tcfg, tcache, mesh)
                assert set(got) == set(want), (set(got), set(want))
                for name, spec in got.items():
                    assert want[name] == {spec}, (name, want[name], spec)


def test_batch_specs_equal_reference():
    """``INPUT_SHAPES``'s batches (train: tokens and labels; prefill:
    tokens and evidence; decode: one token a row) on every mesh, and the
    port's ``INPUT_SHAPES`` equals the reference's."""
    assert {k: tuple(v.__dict__.values()) for k, v in INPUT_SHAPES.items()} \
        == {k: tuple(v.__dict__.values())
            for k, v in J_INPUT_SHAPES.items()}
    for name, sc in INPUT_SHAPES.items():
        B, L = sc.global_batch, sc.seq_len
        batch = {"train": {"tokens": (B, L), "labels": (B, L)},
                 "prefill": {"tokens": (B, L), "evidence": (B, 576, 1024),
                             "mask": (B, L)},
                 "decode": {"token": (B,), "pos": (B,)}}[sc.mode]
        jbatch = {k: jax.ShapeDtypeStruct(v, np.int32)
                  for k, v in batch.items()}
        for mesh in MESHES:
            want = jshd.batch_specs(J_INPUT_SHAPES[name], jbatch, mesh)
            got = shd.batch_specs(sc, batch, mesh)
            assert got == {k: _pad(want[k], len(v))
                           for k, v in batch.items()}, (name, mesh.shape)


def test_serving_helpers_equal_reference():
    """``batch_leading_spec``, ``dp_axes`` and ``prefill_shard_ids``."""
    for mesh in MESHES:
        assert shd.dp_axes(mesh) == jshd.dp_axes(mesh)
        for shape in [(), (8,), (12, 64), (32, 3, 5), (3, 7)]:
            assert shd.batch_leading_spec(mesh, shape) == _pad(
                jshd.batch_leading_spec(mesh, shape), len(shape))
    for dp in range(1, 5):
        for k in range(dp + 1):
            assert shd.prefill_shard_ids(dp, k) == \
                jshd.prefill_shard_ids(dp, k)
        with pytest.raises(ValueError):
            shd.prefill_shard_ids(dp, dp + 1)


def test_meshes():
    """The port's meshes: shapes and axes as the reference's; the serving
    mesh puts every position on the one device, and without a GPU it
    raises unless asked for the CPU."""
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    pod = make_production_mesh(multi_pod=True)
    assert (pod.axis_names, pod.size) == (("pod", "data", "model"), 512)
    assert make_local_mesh((2, 2)).shape == {"data": 2, "model": 2}
    m = make_serve_mesh(4, device="cpu")
    assert (m.shape, m.axis_names, m.size) == \
        ({"data": 4, "model": 1}, ("data", "model"), 4)
    assert m.devices == (torch.device("cpu"),) * 4
    assert make_serve_mesh(0, device="cpu").shape["data"] == 1
    assert make_production_mesh().devices is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_serve_mesh(2)

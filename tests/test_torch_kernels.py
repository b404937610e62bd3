"""The port's attention kernels, on the CPU and (marked ``gpu``) the card.

On the CPU the kernel wrappers run their plain PyTorch versions
(``repro_torch.kernels.ref``); those are held against the JAX package's
oracles (``repro.kernels.ref``) and its Pallas kernels in interpret mode,
as ``tests/test_kernels.py`` and ``tests/test_paged_attention.py`` run
them, on the same numpy inputs: fp32 within atol/rtol 2e-5, bf16 within
2e-2. The CUDA kernels themselves are held against these plain versions
on the card by ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as pallas_paged
from repro.models.attention import kv_quantize as jquantize
from repro_torch.kernels import ops, ref
from torch_ranks import _one_torch_thread  # noqa: F401

TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x, dtype):
    """The same values as a jnp array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x).astype(jnp.dtype(dtype))
    tt = torch.from_numpy(np.array(x, np.float32)).to(TDT[dtype])
    return j, tt


def _close(exp, out, dtype):
    np.testing.assert_allclose(np.asarray(exp, np.float32),
                               out.float().numpy(), **TOLS[dtype])


def _expand(x, rep):
    return np.repeat(x, rep, axis=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,H,Hkv,hd,causal,window", [
    (64, 2, 2, 64, True, 0), (200, 4, 2, 64, True, 0),
    (130, 2, 1, 128, True, 48), (37, 2, 2, 16, False, 0)])
def test_flash_plain_matches_reference(dtype, L, H, Hkv, hd, causal,
                                       window):
    rng = np.random.default_rng(L + H + hd)
    B = 2
    q = rng.standard_normal((B, L, H, hd))
    k = rng.standard_normal((B, L, Hkv, hd))
    v = rng.standard_normal((B, L, Hkv, hd))
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(_expand(k, H // Hkv), dtype)
    jv, tv = _pair(_expand(v, H // Hkv), dtype)
    _, tkg = _pair(k, dtype)
    _, tvg = _pair(v, dtype)
    exp = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    # the reference's expanded heads and the port's grouped ones
    _close(exp, ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                        window=window), dtype)
    _close(exp, ops.flash_attention(tq, tkg, tvg, causal=causal,
                                    window=window), dtype)
    if dtype == "float32":
        pal = pallas_flash(jq, jk, jv, causal=causal, window=window,
                           blk_q=128, blk_k=128, interpret=True)
        _close(pal, ops.flash_attention(tq, tkg, tvg, causal=causal,
                                        window=window), dtype)


@pytest.mark.parametrize("H,Hkv", [(4, 2), (6, 2)])
def test_flash_plain_with_lengths_matches_reference(H, Hkv):
    """Key lengths (a right-padded prefill bucket): K2's plain version
    masks keys past each row's length as the reference's plain path does
    with its key mask (``repro.models.attention.sdpa``), pad rows
    included."""
    from repro.models.attention import sdpa as jsdpa
    rng = np.random.default_rng(H)
    B, L, hd = 3, 40, 64
    lens = np.array([40, 7, 23], np.int32)
    q, k, v = (rng.standard_normal((B, L, n, hd)).astype(np.float32)
               for n in (H, Hkv, Hkv))
    exp = jsdpa(q, k, v, causal=True,
                kv_mask=np.arange(L)[None, :] < lens[:, None])
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _close(exp, ops.flash_attention(tq, tk, tv, lengths=torch.from_numpy(
        lens)), "float32")
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(tq, tk, tv, window=16,
                            lengths=torch.from_numpy(lens))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,Hkv,hd", [(128, 4, 1, 64), (300, 8, 2, 64),
                                        (96, 4, 4, 128)])
def test_decode_plain_matches_reference(dtype, S, H, Hkv, hd):
    rng = np.random.default_rng(S + H)
    B = 2
    jq, tq = _pair(rng.standard_normal((B, 1, H, hd)), dtype)
    jk, tk = _pair(rng.standard_normal((B, S, Hkv, hd)), dtype)
    jv, tv = _pair(rng.standard_normal((B, S, Hkv, hd)), dtype)
    mask = rng.random((B, S)) < 0.75
    mask[:, :2] = True
    exp = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(mask))
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(mask))
    _close(exp, out, dtype)
    if dtype == "float32":
        pal = pallas_decode(jq, jk, jv, jnp.asarray(mask), blk_s=128,
                            interpret=True)
        _close(pal, out, dtype)


@pytest.mark.parametrize("B,Hkv,S", [
    (8, 8, 288), (8, 8, 32768),       # must fill 132 SMs
    (8, 8, 16), (8, 8, 64), (8, 8, 4096), (2, 2, 300), (1, 1, 1),
    (1, 8, 32768), (300, 8, 64), (8, 8, 1000), (8, 24, 288),
    # paged capacities n * ps: llava's 54 x 16 (must fill 132 SMs), a
    # ragged last split 63 x 16, pages of 8, 64 and 6 rows, n 4 x 16
    (8, 32, 864), (4, 2, 1008), (3, 2, 320), (2, 8, 640), (3, 2, 300),
    (3, 4, 64)])
def test_decode_splits_cover_the_cache(B, Hkv, S):
    """The split plan of the decode kernels cuts [0, S) into runs of
    whole 16-row tiles (the last may be ragged) without overlap or empty
    splits, and fills an H100's 132 SMs at the serving shapes. The paged
    kernel plans over its block table's capacity n * ps, so a row shorter
    than that has its live splits first and only empty ones after."""
    n, rows = ops.decode_splits(B, Hkv, S, 132)
    assert 1 <= n <= ops.DEC_MAX_SPLIT
    assert rows % ops.DEC_TILE == 0 and rows > 0
    runs = [(s * rows, min(S, (s + 1) * rows)) for s in range(n)]
    assert runs[0][0] == 0 and runs[-1][1] == max(S, 0)
    for (a0, a1), (b0, _) in zip(runs, runs[1:]):
        assert a1 == b0 and a1 - a0 == rows
    assert S <= 0 or runs[-1][1] > runs[-1][0]
    for length in (1, S // 2 + 1, S):
        live = [s for s, (a0, _) in enumerate(runs) if a0 < length]
        assert live == list(range(-(-length // rows)))
    if (B, Hkv, S) in ((8, 8, 288), (8, 8, 32768), (8, 32, 864)):
        assert B * Hkv * n >= 132
    if S <= ops.DEC_TILE:
        assert n == 1


@pytest.mark.parametrize("pool", [torch.float32, torch.int8])
def test_paged_wrapper_reads_no_device_value(monkeypatch, pool):
    """The card path of the K1 wrapper, driven with tensors that claim to
    lie on the card but hold no data (meta tensors): it plans from shapes,
    allocates the split workspace and hands the C entry point one argument
    per declared parameter, without reading any value. Reading one, the
    lengths' maximum say, would raise here; on the card it would wait for
    the device at every decode step."""
    from repro_torch.kernels import build

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    def empty(*shape, dtype=torch.float32):
        return torch.Tensor._make_subclass(
            OnCard, torch.empty(shape, dtype=dtype, device="meta"))

    launched = []
    monkeypatch.setattr(ops, "_sms", lambda t: 132)
    monkeypatch.setattr(ops, "_launch",
                        lambda name, *args: launched.append((name, args)))
    B, H, Hkv, hd, ps, n = 8, 16, 8, 128, 16, 18
    P = B * n + 1
    scales = {}
    if pool == torch.int8:
        scales = dict(k_scale=empty(P, ps, Hkv), v_scale=empty(P, ps, Hkv))
    q = empty(B, 1, H, hd)
    out = ops.paged_decode_attention(
        q, empty(P, ps, Hkv, hd, dtype=pool), empty(P, ps, Hkv, hd,
                                                    dtype=pool),
        empty(B, n, dtype=torch.int32), empty(B, dtype=torch.int32),
        **scales)
    assert out.shape == q.shape and out.device.type == "meta"
    (name, args), = launched
    assert name == "paged_decode_attention"
    assert len(args) == len(build.KERNELS[name][1]) - 1   # and the stream
    assert args[-4:-2] == ops.decode_splits(B, Hkv, n * ps, 132)


def _paged_inputs(rng, B, H, Hkv, hd, ps, n):
    P = B * n + 2
    q = rng.standard_normal((B, 1, H, hd))
    kp = rng.standard_normal((P, ps, Hkv, hd))
    vp = rng.standard_normal((P, ps, Hkv, hd))
    bt = (1 + rng.permutation(P - 1)[:B * n]).reshape(B, n).astype(np.int32)
    return q, kp, vp, bt


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "fp8"])
@pytest.mark.parametrize("ps,Hkv,H", [(16, 2, 8), (8, 1, 4), (64, 4, 4)])
def test_paged_plain_matches_reference(pool, ps, Hkv, H):
    rng = np.random.default_rng(ps + H)
    B, hd, n = 3, 64, 4
    q, kp, vp, bt = _paged_inputs(rng, B, H, Hkv, hd, ps, n)
    # ragged: a one-token row, a mid-page row, an exactly-full row
    lengths = np.array([1, (n - 1) * ps + ps // 2 + 1, n * ps], np.int32)
    dtype = "bfloat16" if pool == "bfloat16" else "float32"
    jq, tq = _pair(q, dtype)
    jbt, jln = jnp.asarray(bt), jnp.asarray(lengths)
    tbt, tln = torch.from_numpy(bt), torch.from_numpy(lengths)
    if pool in ("int8", "fp8"):
        qd = jnp.int8 if pool == "int8" else jnp.float8_e4m3fn
        jk, jks = jquantize(jnp.asarray(kp, jnp.float32), qd)
        jv, jvs = jquantize(jnp.asarray(vp, jnp.float32), qd)
        tdt = torch.int8 if pool == "int8" else torch.float8_e4m3fn
        tk = torch.from_numpy(np.array(jk).view(np.uint8)).view(tdt)
        tv = torch.from_numpy(np.array(jv).view(np.uint8)).view(tdt)
        tks, tvs = torch.from_numpy(np.array(jks)), \
            torch.from_numpy(np.array(jvs))
    else:
        jk, tk = _pair(kp, dtype)
        jv, tv = _pair(vp, dtype)
        jks = jvs = tks = tvs = None
    exp = jref.paged_decode_attention_ref(jq, jk, jv, jbt, jln, k_scale=jks,
                                          v_scale=jvs)
    out = ops.paged_decode_attention(tq, tk, tv, tbt, tln, k_scale=tks,
                                     v_scale=tvs)
    _close(exp, out, dtype)
    if pool in ("float32", "int8"):
        pal = pallas_paged(jq, jk, jv, jbt, jln, k_scale=jks, v_scale=jvs,
                           interpret=True)
        _close(pal, out, dtype)


def test_cpu_tensors_take_the_plain_path():
    """CPU tensors never reach a CUDA kernel: no launch is counted."""
    rng = np.random.default_rng(7)
    ops.reset_launches()
    q = torch.from_numpy(rng.standard_normal((1, 16, 2, 16)).astype(
        np.float32))
    ops.flash_attention(q, q, q)
    ops.decode_attention(q[:, :1], q, q, torch.ones(1, 16, dtype=torch.bool))
    ops.paged_decode_attention(q[:, :1], q.reshape(2, 8, 2, 16),
                               q.reshape(2, 8, 2, 16),
                               torch.zeros(1, 2, dtype=torch.int32),
                               torch.full((1,), 16, dtype=torch.int32))
    x = q.reshape(1, 32, 16)
    ops.xmodal_score(x, torch.ones(1, 32), x, x)
    ops.moe_dispatch(torch.full((1, 2, 8), -1, dtype=torch.int32), x)
    ops.moe_combine(torch.zeros(1, 32, 2, dtype=torch.int32),
                    torch.ones(1, 32, 2), x.reshape(1, 2, 16, 16))
    assert ops.LAUNCHES == {"flash_attention": 0, "decode_attention": 0,
                            "paged_decode_attention": 0,
                            "xmodal_score_mean": 0, "xmodal_score_max": 0,
                            "moe_dispatch": 0, "moe_combine": 0}
    with pytest.raises(ValueError, match="both"):
        ops.paged_decode_attention(q[:, :1], q, q, None, None,
                                   k_scale=torch.ones(1))

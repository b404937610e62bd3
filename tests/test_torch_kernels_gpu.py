"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA
device. The module imports neither JAX nor the JAX package, so it runs on
a machine with only PyTorch; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: fp32 within atol/rtol 2e-5, bf16 within 2e-2 (the kernels
accumulate in fp32 in another order than the plain versions). The
cross-modal score kernels take fp32 tolerances at both input types: they
and their plain versions compute in fp32 from the same bf16 values.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.attention import kv_quantize

TOLS = {torch.float32: dict(rtol=2e-5, atol=2e-5),
        torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(g, shape, dtype=torch.float32):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _close(out, exp, dtype):
    torch.testing.assert_close(out.float(), exp.float(), **TOLS[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_kernel_on_card(gen, dtype, hd):
    for L, causal, window in ((256, True, 0), (200, True, 0),
                              (300, True, 96), (37, False, 0)):
        q = _rand(gen, (2, L, 8, hd), dtype)
        k = _rand(gen, (2, L, 4, hd), dtype)
        v = _rand(gen, (2, L, 4, hd), dtype)
        _close(ops.flash_attention(q, k, v, causal=causal, window=window),
               ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_kernel_on_card(gen, dtype):
    B, S, H, Hkv, hd = 4, 300, 8, 4, 128
    q = _rand(gen, (B, 1, H, hd), dtype)
    k = _rand(gen, (B, S, Hkv, hd), dtype)
    v = _rand(gen, (B, S, Hkv, hd), dtype)
    mask = torch.rand(B, S, generator=gen, device="cuda") < 0.7
    mask[:, 0] = True
    _close(ops.decode_attention(q, k, v, mask),
           ref.decode_attention_ref(q, k, v, mask), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8,
                                  torch.float8_e4m3fn])
def test_paged_decode_kernel_on_card(gen, pool):
    B, H, Hkv, hd, ps, n = 4, 8, 4, 128, 16, 6
    P = B * n + 1
    dtype = torch.bfloat16 if pool == torch.bfloat16 else torch.float32
    q = _rand(gen, (B, 1, H, hd), dtype)
    kf = _rand(gen, (P, ps, Hkv, hd))
    vf = _rand(gen, (P, ps, Hkv, hd))
    ks = vs = None
    if pool in (torch.int8, torch.float8_e4m3fn):
        kp, ks = kv_quantize(kf, pool)
        vp, vs = kv_quantize(vf, pool)
    else:
        kp, vp = kf.to(pool), vf.to(pool)
    bt = (torch.randperm(P - 1, generator=gen, device="cuda") + 1
          ).reshape(B, n).to(torch.int32)
    ln = torch.tensor([1, 17, 50, n * ps], dtype=torch.int32, device="cuda")
    before = ops.LAUNCHES["paged_decode_attention"]
    _close(ops.paged_decode_attention(q, kp, vp, bt, ln, k_scale=ks,
                                      v_scale=vs),
           ref.paged_decode_attention_ref(q, kp, vp, bt, ln, k_scale=ks,
                                          v_scale=vs), dtype)
    assert ops.LAUNCHES["paged_decode_attention"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,Nv,Nt,d", [
    (3, 1, 7, 129, 48),          # ragged everywhere, d not a chunk multiple
    (2, 33, 65, 31, 100),
    (1, 32, 576, 256, 4096),     # the serving shape
])
def test_xmodal_kernels_on_card(gen, dtype, B, L, Nv, Nt, d):
    tok, vis, txt = (_rand(gen, (B, n, d), dtype) for n in (L, Nv, Nt))
    k = min(Nv, Nt)                      # some strong text-visual matches
    vis[:, :k] = (vis[:, :k].float() + 2 * txt[:, :k].float()).to(dtype)
    mask = (torch.rand(B, L, generator=gen, device="cuda") < 0.7).float()
    mask[-1] = 0.0                       # a row with no live token
    tol = TOLS[torch.float32]
    before = dict(ops.LAUNCHES)
    torch.testing.assert_close(ops.xmodal_mean_sum(tok, mask, vis),
                               ref.xmodal_mean_sum_ref(tok, mask, vis), **tol)
    torch.testing.assert_close(ops.xmodal_max_sum(txt, vis),
                               ref.xmodal_max_sum_ref(txt, vis), **tol)
    out = ops.xmodal_score(tok, mask, vis, txt)
    torch.testing.assert_close(out, ref.xmodal_score_ref(tok, mask, vis, txt),
                               **tol)
    for name in ("xmodal_score_mean", "xmodal_score_max"):
        assert ops.LAUNCHES[name] == before[name] + 2
    # no float atomics: a second run gives the same bits
    assert torch.equal(out, ops.xmodal_score(tok, mask, vis, txt))


@pytest.mark.gpu
def test_wrappers_reject_bad_input_on_card(gen):
    q = _rand(gen, (1, 16, 2, 64))
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                            q[..., :48].contiguous())
    with pytest.raises(ValueError, match="lie on"):
        ops.decode_attention(q[:, :1].contiguous(), q.cpu(), q,
                             torch.ones(1, 16, dtype=torch.bool,
                                        device="cuda"))
    x = q.reshape(1, 32, 64)
    with pytest.raises(ValueError, match="mask"):
        ops.xmodal_score(x, torch.ones(1, 32, device="cuda",
                                       dtype=torch.bfloat16), x, x)
    with pytest.raises(ValueError, match="alike"):
        ops.xmodal_score(x, torch.ones(1, 32, device="cuda"),
                         x.to(torch.bfloat16), x)

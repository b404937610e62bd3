"""The port's CUDA kernels against their plain versions, on the card,
and the serving engine's macro-step as one CUDA graph against the same
body run eagerly.

Every test here carries the ``gpu`` marker and skips without a CUDA
device. The module imports neither JAX nor the JAX package, so it runs on
a machine with only PyTorch; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: fp32 within atol/rtol 2e-5, bf16 within 2e-2 (the kernels
accumulate in fp32 in another order than the plain versions; the flash
kernel's fp32 products are 3xTF32, about 21 bits each). The
cross-modal score kernels take fp32 tolerances at both input types: they
and their plain versions compute in fp32 from the same bf16 values.
"""
import pytest
import torch

from repro_torch.config import PagedKVConfig, SamplingConfig
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models.attention import kv_quantize
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Request, ServeEngine

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
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_kernel_on_card(gen, dtype, hd):
    """K2 (3xTF32 tensor-core products in fp32, one TF32 pass in bf16)
    at every head_dim it takes: causal prompts of a whole tile, a ragged
    last tile (200, 37) and llava's 832, a 4096-token row (the 3xTF32
    error over many keys), a sliding window whose edge cuts a diagonal
    tile, a non-causal row, and key lengths. One launch a call; two runs
    give the same bits."""
    for L, causal, window, lens in ((256, True, 0, None),
                                    (200, True, 0, None),
                                    (832, True, 0, None),
                                    (4096, True, 0, None),
                                    (300, True, 96, None),
                                    (37, False, 0, None),
                                    (200, True, 0, [200, 37])):
        q = _rand(gen, (2, L, 8, hd), dtype)
        k = _rand(gen, (2, L, 4, hd), dtype)
        v = _rand(gen, (2, L, 4, hd), dtype)
        ln = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device="cuda")
        before = ops.LAUNCHES["flash_attention"]
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  lengths=ln)
        _close(out, ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window, lengths=ln),
               dtype)
        assert torch.equal(out, ops.flash_attention(
            q, k, v, causal=causal, window=window, lengths=ln))
        assert ops.LAUNCHES["flash_attention"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_hd256_on_card(gen, dtype):
    """K2 at head_dim 256 (recurrentgemma-2b's local attention: 10 query
    heads over one kv head): a one-row prefill of a whole tile, a ragged
    row, windows that bind (L 600 against 256, L 300 against 96: the
    window's edge cuts diagonal tiles), key lengths and a non-causal row.
    Two runs give the same bits."""
    for L, causal, window, lens in ((256, True, 2048, None),
                                    (200, True, 0, None),
                                    (600, True, 256, None),
                                    (300, True, 96, None),
                                    (130, True, 0, [130, 17]),
                                    (37, False, 0, None)):
        B = 1 if lens is None else 2
        q = _rand(gen, (B, L, 10, 256), dtype)
        k = _rand(gen, (B, L, 1, 256), dtype)
        v = _rand(gen, (B, L, 1, 256), dtype)
        ln = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device="cuda")
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  lengths=ln)
        _close(out, ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window, lengths=ln),
               dtype)
        assert torch.equal(out, ops.flash_attention(
            q, k, v, causal=causal, window=window, lengths=ln))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_hd256_on_card(gen, dtype):
    """K3 at head_dim 256 on its wide body, G 10 run as 2 groups of 5:
    recurrentgemma's served decode (B 8, S 288, a ring mask), a 512-slot
    ring whose positions wrapped past it with a window of 300 binding, G 1
    and G 4, and a row with no valid key, under several splits and one.
    Two runs give the same bits."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, S, H, Hkv, kind in ((8, 288, 10, 1, "ring"),
                               (4, 512, 10, 1, "wrapped window"),
                               (3, 200, 2, 2, "ring"),
                               (2, 300, 8, 2, "ring"),
                               (3, 300, 10, 1, "empty row"),
                               (3, 16, 10, 1, "empty row")):
        q = _rand(gen, (B, 1, H, 256), dtype)
        k = _rand(gen, (B, S, Hkv, 256), dtype)
        v = _rand(gen, (B, S, Hkv, 256), dtype)
        slot = torch.arange(S, device="cuda")
        pos = torch.randint(0, S, (B,), generator=gen, device="cuda")
        if kind == "wrapped window":
            pos = pos + 3 * S
        p = pos[:, None]
        slot_pos = p - torch.remainder(p - slot[None, :], S)
        mask = slot_pos >= 0
        if kind == "wrapped window":
            mask &= slot_pos > p - 300
            assert bool((~mask).any(1).all())
        if kind == "empty row":
            mask[1] = False
        n_split, _ = ops.decode_splits(B, Hkv * ops.decode_groups(H // Hkv),
                                       S, sms)
        assert (n_split == 1) == (S == 16)
        out = ops.decode_attention(q, k, v, mask)
        _close(out, ref.decode_attention_ref(q, k, v, mask), dtype)
        assert torch.equal(out, ops.decode_attention(q, k, v, mask))
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_decode_attention(
            q[:, :, :1].contiguous(), k[:1].reshape(S, 1, 1, 256),
            v[:1].reshape(S, 1, 1, 256),
            torch.zeros(B, 1, dtype=torch.int32, device="cuda"),
            torch.ones(B, dtype=torch.int32, device="cuda"))


@pytest.mark.gpu
def test_kernel_refuses_inputs_that_require_grad(gen):
    """No kernel has a backward: K2 on a q that requires grad raises under
    grad mode (its output would carry no grad_fn, and q's gradient would
    go missing) and launches, equal to its plain version, under
    ``no_grad``."""
    q = _rand(gen, (2, 64, 4, 64)).requires_grad_(True)
    k, v = _rand(gen, (2, 64, 2, 64)), _rand(gen, (2, 64, 2, 64))
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.flash_attention(q, k, v)
    assert ops.LAUNCHES["flash_attention"] == 0
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
        exp = ref.flash_attention_ref(q, k, v, causal=True)
    assert ops.LAUNCHES["flash_attention"] == 1 and out.grad_fn is None
    _close(out, exp, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_unaligned_on_card(gen, dtype):
    """Contiguous q/k/v whose bases are not 16-byte aligned (views one
    element into a buffer): K2 copies them element by element instead of
    by 16-byte cp.async, with the same result."""
    B, L, H, Hkv, hd = 2, 200, 8, 4, 64

    def unaligned(shape):
        n = B * L * shape * hd
        return _rand(gen, (n + 1,), dtype)[1:].view(B, L, shape, hd)

    q, k, v = unaligned(H), unaligned(Hkv), unaligned(Hkv)
    assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    _close(ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v),
           dtype)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["first split only", "one split",
                                  "ragged last split", "granite G 3",
                                  "no valid row", "no valid row, one split",
                                  "G 8", "hd 33", "hd 36"])
def test_dense_decode_split_cases_on_card(gen, dtype, case):
    """The split-KV plan's edge cases: only the first split holds valid
    rows (the rest weigh exactly 0), a plan of one split (no combine), an
    S that is not a multiple of the split length, granite's 24/8 heads of
    width 64, and a batch row with no valid row under a plan of several
    splits and under one split (the mean of V over all S rows, as the
    plain version's softmax over scores that are all -1e30 gives it).
    Then the instantiations the serving shapes
    do not reach: eight query heads per kv head, and rows whose byte
    length is no multiple of 16, copied in 4-byte units (fp32 hd 33, bf16
    hd 36) or 2-byte units (bf16 hd 33). Two runs give the same bits."""
    B, S, H, Hkv, hd = {"first split only": (8, 4096, 16, 8, 128),
                        "one split": (8, 16, 16, 8, 128),
                        "ragged last split": (4, 1000, 8, 2, 64),
                        "granite G 3": (8, 288, 24, 8, 64),
                        "no valid row": (3, 300, 8, 4, 128),
                        "no valid row, one split": (3, 16, 8, 4, 128),
                        "G 8": (2, 300, 16, 2, 128),
                        "hd 33": (3, 500, 8, 4, 33),
                        "hd 36": (2, 200, 6, 2, 36)}[case]
    n_split, rows = ops.decode_splits(
        B, Hkv, S, torch.cuda.get_device_properties(0).multi_processor_count)
    q = _rand(gen, (B, 1, H, hd), dtype)
    k = _rand(gen, (B, S, Hkv, hd), dtype)
    v = _rand(gen, (B, S, Hkv, hd), dtype)
    mask = torch.rand(B, S, generator=gen, device="cuda") < 0.7
    mask[:, 0] = True
    if case == "first split only":
        assert n_split > 1
        mask[:, rows // 2:] = False
    elif case == "one split":
        assert n_split == 1
    elif case == "ragged last split":
        assert S % rows != 0
    elif case.startswith("no valid row"):
        assert (n_split == 1) == case.endswith("one split")
        mask[1] = False
    else:
        assert n_split > 1
    before = ops.LAUNCHES["decode_attention"]
    out = ops.decode_attention(q, k, v, mask)
    _close(out, ref.decode_attention_ref(q, k, v, mask), dtype)
    assert torch.equal(out, ops.decode_attention(q, k, v, mask))
    assert ops.LAUNCHES["decode_attention"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8,
                                  torch.float8_e4m3fn])
def test_paged_decode_kernel_on_card(gen, pool):
    B, H, Hkv, hd, ps, n = 5, 8, 4, 128, 16, 6
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
    # row 2 has no valid key: the mean of V over its n * ps slots
    ln = torch.tensor([1, 17, 0, 50, n * ps], dtype=torch.int32,
                      device="cuda")
    before = ops.LAUNCHES["paged_decode_attention"]
    _close(ops.paged_decode_attention(q, kp, vp, bt, ln, k_scale=ks,
                                      v_scale=vs),
           ref.paged_decode_attention_ref(q, kp, vp, bt, ln, k_scale=ks,
                                          v_scale=vs), dtype)
    assert ops.LAUNCHES["paged_decode_attention"] == before + 1


# (B, H, Hkv, hd, ps, n, lengths); None: lengths below the first split's end
PAGED_SPLIT_CASES = {
    "first split only": (8, 16, 8, 128, 16, 256, None),
    "one split": (8, 16, 8, 128, 16, 1, [1, 2, 5, 8, 11, 13, 15, 16]),
    "ragged last split": (4, 8, 2, 64, 16, 63, [1008, 1001, 977, 100]),
    "lengths past n*ps": (3, 8, 4, 128, 16, 4, [69, 164, 64]),
    "shared pages": (4, 16, 8, 128, 16, 18, [288, 200, 150, 30]),
    "page ids out of range": (3, 16, 8, 128, 16, 18, [288, 250, 100]),
    "no valid row": (3, 8, 4, 128, 16, 20, [300, 0, 77]),
    "no valid row, one split": (3, 8, 4, 128, 16, 1, [16, 0, 5]),
    "granite G 3": (8, 24, 8, 64, 16, 18, [257 + 4 * i for i in range(8)]),
    "ps 8": (3, 8, 2, 128, 8, 40, [320, 171, 9]),
    "ps 64": (2, 16, 8, 128, 64, 10, [640, 300]),
    "ps 6": (3, 8, 2, 64, 6, 50, [300, 133, 7]),
    "G 8": (2, 16, 2, 128, 16, 19, [300, 151]),
    "hd 33": (3, 8, 4, 33, 16, 32, [500, 250, 17]),
    "hd 36": (2, 6, 2, 36, 16, 13, [200, 101]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8,
                                  torch.float8_e4m3fn])
@pytest.mark.parametrize("case", list(PAGED_SPLIT_CASES))
def test_paged_decode_split_cases_on_card(gen, pool, case):
    """K1 on the split-KV body at the plan's edges (only the first split
    live, one split and no combine, a ragged last split, lengths past
    n * ps, clipped), at block tables the engine makes or must survive
    (two rows sharing pages, as copy-on-write seeding leaves them; page
    ids out of range, clipped), at a batch row with no valid key under
    several splits and under one (the mean of V over the row's n * ps
    gathered slots, dequantized, as the plain version gives it),
    at granite's 24/8 heads of width 64, at pages of 8, 64 and 6 rows (6
    is no multiple of 4: rows are looked up one by one), at eight query
    heads per kv head, and at hd 33 and 36 (rows copied in 4-, 2- and
    1-byte units). The wrapper plans from shapes alone: it runs under
    CUDA's sync debug mode set to raise. Two runs give the same bits."""
    B, H, Hkv, hd, ps, n, lens = PAGED_SPLIT_CASES[case]
    n_split, rows = ops.decode_splits(
        B, Hkv, n * ps,
        torch.cuda.get_device_properties(0).multi_processor_count)
    if lens is None:
        assert n_split > 1
        lens = torch.randint(1, rows, (B,), generator=gen,
                             device="cuda").tolist()
    P = B * n + 3
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
    bt = (torch.randperm(P - 1, generator=gen, device="cuda")[:B * n] + 1
          ).reshape(B, n).to(torch.int32)
    if case == "shared pages":
        bt[1, :13] = bt[0, :13]
    elif case == "page ids out of range":
        bt[0, 1], bt[1, 0], bt[2, 5] = -5, P + 7, -1
    ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = ops.LAUNCHES["paged_decode_attention"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ops.paged_decode_attention(q, kp, vp, bt, ln, k_scale=ks,
                                         v_scale=vs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    exp = ref.paged_decode_attention_ref(q, kp, vp, bt, ln, k_scale=ks,
                                         v_scale=vs)
    if case.startswith("no valid row"):
        assert (n_split == 1) == case.endswith("one split")
    _close(out, exp, dtype)
    assert torch.equal(out, ops.paged_decode_attention(
        q, kp, vp, bt, ln, k_scale=ks, v_scale=vs))
    assert ops.LAUNCHES["paged_decode_attention"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("pool", [torch.float32, torch.bfloat16, torch.int8,
                                  torch.float8_e4m3fn])
@pytest.mark.parametrize("G,Hkv", [(48, 1), (12, 2), (5, 8), (7, 8)])
def test_decode_kernels_any_g_on_card(gen, pool, G, Hkv):
    """K3 (dense cache, fp32 and bf16 only) and K1 at granite-34b's 48
    query heads over one kv head, at 12 over each of 2 (groups of 6, no
    multiple of 8), and at qwen2.5-32b's 5 and yi-34b's 7 over 8, with a
    batch row that has no valid key, under several splits (S 4096) and
    one (S 16): a kv head's G > 8 query heads run in groups of at most 8,
    a block each. Two runs give the same bits."""
    B, hd = 4, 128
    H = G * Hkv
    dtype = torch.bfloat16 if pool == torch.bfloat16 else torch.float32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for S in (4096, 16):
        q = _rand(gen, (B, 1, H, hd), dtype)
        n_split, _ = ops.decode_splits(B, Hkv * ops.decode_groups(G), S, sms)
        assert (n_split > 1) == (S > 16)
        if pool in (torch.float32, torch.bfloat16):
            k = _rand(gen, (B, S, Hkv, hd), pool)
            v = _rand(gen, (B, S, Hkv, hd), pool)
            mask = torch.rand(B, S, generator=gen, device="cuda") < 0.7
            mask[:, 0] = True
            mask[2] = False
            out = ops.decode_attention(q, k, v, mask)
            _close(out, ref.decode_attention_ref(q, k, v, mask), dtype)
            assert torch.equal(out, ops.decode_attention(q, k, v, mask))
        ps, n = 16, S // 16
        P = B * n + 1
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
        ln = torch.tensor([S, S // 2 + 3, 0, 1], dtype=torch.int32,
                          device="cuda")
        out = ops.paged_decode_attention(q, kp, vp, bt, ln, k_scale=ks,
                                         v_scale=vs)
        _close(out, ref.paged_decode_attention_ref(
            q, kp, vp, bt, ln, k_scale=ks, v_scale=vs), dtype)
        assert torch.equal(out, ops.paged_decode_attention(
            q, kp, vp, bt, ln, k_scale=ks, v_scale=vs))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,Nv,Nt,d", [
    (3, 1, 7, 129, 48),          # ragged everywhere, d not a chunk multiple
    (2, 33, 65, 31, 100),
    (2, 8, 100, 70, 1004),       # K4b: several splits, Nv not a tile multiple
    (1, 32, 576, 256, 4096),     # the serving shape
])
def test_xmodal_kernels_on_card(gen, dtype, B, L, Nv, Nt, d):
    """K4a (factored: inverse norms, then u = sum_j inv_j vis_j and the
    tokens' dots with it over chunks of d) and K4b (3xTF32 tensor-core
    tiles over splits of d, or one split where d is short), with a zero
    token, visual and text row (inverse norm 1e8 on a zero row adds 0),
    a row with no live token, and rows off a 16-byte boundary (both
    kernels' one-element loads). Two runs give the same bits."""
    tok, vis, txt = (_rand(gen, (B, n, d), dtype) for n in (L, Nv, Nt))
    k = min(Nv, Nt)                      # some strong text-visual matches
    vis[:, :k] = (vis[:, :k].float() + 2 * txt[:, :k].float()).to(dtype)
    tok[0, L // 2] = 0.0
    vis[0, Nv // 2] = 0.0
    txt[0, Nt // 2] = 0.0
    mask = (torch.rand(B, L, generator=gen, device="cuda") < 0.7).float()
    mask[-1] = 0.0                       # a row with no live token
    tol = TOLS[torch.float32]
    n_split, _ = ops.xmodal_max_splits(
        B, Nt, Nv, d, torch.cuda.get_device_properties(0).multi_processor_count)
    assert (n_split > 1) == (d >= 1004)

    def shifted(x):
        y = torch.empty(x.numel() + 2, dtype=dtype, device="cuda")[2:]
        return y.view(x.shape).copy_(x)

    before = dict(ops.LAUNCHES)
    torch.testing.assert_close(ops.xmodal_mean_sum(tok, mask, shifted(vis)),
                               ref.xmodal_mean_sum_ref(tok, mask, vis), **tol)
    torch.testing.assert_close(ops.xmodal_max_sum(shifted(txt), shifted(vis)),
                               ref.xmodal_max_sum_ref(txt, vis), **tol)
    torch.testing.assert_close(ops.xmodal_mean_sum(tok, mask, vis),
                               ref.xmodal_mean_sum_ref(tok, mask, vis), **tol)
    sum2 = ops.xmodal_max_sum(txt, vis)
    torch.testing.assert_close(sum2, ref.xmodal_max_sum_ref(txt, vis), **tol)
    assert torch.equal(sum2, ops.xmodal_max_sum(txt, vis))
    out = ops.xmodal_score(tok, mask, vis, txt)
    torch.testing.assert_close(out, ref.xmodal_score_ref(tok, mask, vis, txt),
                               **tol)
    assert ops.LAUNCHES["xmodal_score_mean"] == before["xmodal_score_mean"] + 3
    assert ops.LAUNCHES["xmodal_score_max"] == before["xmodal_score_max"] + 4
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_with_lengths_on_card(gen, dtype):
    """Key lengths (right-padded prefill rows) at granite's 24/8 heads of
    width 64 (GQA group 3)."""
    B, L, H, Hkv, hd = 3, 200, 24, 8, 64
    q = _rand(gen, (B, L, H, hd), dtype)
    k = _rand(gen, (B, L, Hkv, hd), dtype)
    v = _rand(gen, (B, L, Hkv, hd), dtype)
    for lens in (None, [200, 37, 1]):
        ln = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device="cuda")
        _close(ops.flash_attention(q, k, v, lengths=ln),
               ref.flash_attention_ref(q, k, v, lengths=ln), dtype)


def _moe_tables(g_, G, g, E, C, k):
    from repro_torch.models.moe import dispatch_tables
    logits = torch.randn(G, g, E, generator=g_, device="cuda")
    vals, gate_idx = torch.sort(torch.softmax(logits, -1), dim=-1,
                                descending=True, stable=True)
    gates = (vals[..., :k] / vals[..., :k].sum(-1, keepdim=True)).contiguous()
    idx, slot, _ = dispatch_tables(gate_idx[..., :k], E, C)
    return idx, slot, gates


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,g,E,C,k,d", [
    (8, 256, 40, 64, 8, 1536),     # granite's prefill bucket
    (1, 8, 40, 8, 8, 1536),        # granite's decode step
    (2, 37, 5, 8, 3, 1001),        # d not a multiple of 4, capacity binds
    (3, 24, 6, 8, 1, 130),         # k = 1
])
def test_moe_kernels_on_card(gen, dtype, G, g, E, C, k, d):
    """K5a equals its plain version bit for bit, K5b within the dtype's
    tolerance; both repeat bitwise."""
    idx, slot, gates = _moe_tables(gen, G, g, E, C, k)
    x = _rand(gen, (G, g, d), dtype)
    eo = _rand(gen, (G, E, C, d), dtype)
    before = dict(ops.LAUNCHES)
    out = ops.moe_dispatch(idx, x)
    assert torch.equal(out, ref.moe_dispatch_ref(idx, x))
    assert torch.equal(out, ops.moe_dispatch(idx, x))
    comb = ops.moe_combine(slot, gates, eo)
    _close(comb, ref.moe_combine_ref(slot, gates, eo), dtype)
    assert torch.equal(comb, ops.moe_combine(slot, gates, eo))
    for name in ("moe_dispatch", "moe_combine"):
        assert ops.LAUNCHES[name] == before[name] + 2
    # ids outside [0, E * C) are dropped; tables and rows off a 16-byte
    # boundary take K5b's shuffled ids (k = 8 too) and one-element loads
    bad = torch.where(slot == slot.max(), E * C + 3, slot)
    bad[..., 0] = torch.where(bad[..., 0] < 0, -7, bad[..., 0])

    def shifted(x):
        out = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device="cuda")[1:].view(x.shape)
        return out.copy_(x)

    _close(ops.moe_combine(shifted(bad), shifted(gates), shifted(eo)),
           ref.moe_combine_ref(bad, gates, eo), dtype)
    # every slot empty, every choice dropped
    none = torch.full_like(idx, -1)
    assert torch.equal(ops.moe_dispatch(none, x), torch.zeros_like(out))
    assert torch.equal(ops.moe_combine(torch.full_like(slot, -1), gates, eo),
                       torch.zeros_like(comb))


@pytest.mark.gpu
def test_moe_wrappers_reject_bad_input_on_card(gen):
    idx, slot, gates = _moe_tables(gen, 1, 8, 4, 8, 2)
    x = _rand(gen, (1, 8, 64))
    eo = _rand(gen, (1, 4, 8, 64))
    with pytest.raises(ValueError, match="int32"):
        ops.moe_dispatch(idx.long(), x)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ops.moe_dispatch(idx, x.half())
    with pytest.raises(ValueError, match="G, g, d"):
        ops.moe_dispatch(idx, x[0])
    with pytest.raises(ValueError, match="gates fp32"):
        ops.moe_combine(slot, gates.to(torch.bfloat16), eo)
    with pytest.raises(ValueError, match="expert_out"):
        ops.moe_combine(slot, gates, eo[0])
    with pytest.raises(ValueError, match="contiguous"):
        ops.moe_combine(slot, gates, eo.transpose(2, 3))
    with pytest.raises(ValueError, match="k 33"):
        many = torch.zeros(1, 8, 33, dtype=torch.int32, device="cuda")
        ops.moe_combine(many, torch.ones(1, 8, 33, device="cuda"), eo)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(x[None].reshape(1, 8, 1, 64),
                            x[None].reshape(1, 8, 1, 64),
                            x[None].reshape(1, 8, 1, 64), window=4,
                            lengths=torch.ones(1, dtype=torch.int32,
                                               device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dispatch_decode_grid_on_card(gen, dtype):
    """K5a at granite's decode shape (G 1, g 8, E 40, C 8, d 1536) with
    empty slots and ids outside [0, g) among the slots: bit for bit with
    its plain version, twice."""
    G, g, E, C, d = 1, 8, 40, 8, 1536
    idx = torch.randint(-2, g + 2, (G, E, C), generator=gen, device="cuda",
                        dtype=torch.int32)
    x = _rand(gen, (G, g, d), dtype)
    out = ops.moe_dispatch(idx, x)
    assert torch.equal(out, ref.moe_dispatch_ref(idx, x))
    assert torch.equal(out, ops.moe_dispatch(idx, x))


# ---------------------------------------------------------------------------
# the serving engine on the card: the macro-step as one CUDA graph
# ---------------------------------------------------------------------------

def _engine_on_card(arch, K, *, impl="paged_cuda", kv_dtype="auto",
                    mode="camd", sampling=None):
    """A reduced config with seeded random weights on the card, and the
    serve CLI's synthetic requests (4 of 12 tokens; image requests for
    llava). Returns (engine, requests)."""
    cfg = get_config(arch).reduced().with_overrides(dtype="float32")
    model = build_model(cfg, torch.float32, device="cuda", seed=0)
    args = serve.parse_args(["--arch", arch, "--requests", "4",
                             "--prompt-len", "12", "--seed", "0"])
    eng = ServeEngine(model, slots=8, cache_len=64, mode=mode,
                      sampling=sampling or SamplingConfig(max_new_tokens=8),
                      max_new_tokens=8, eos_id=cfg.vocab_size, impl=impl,
                      paged_kv=PagedKVConfig(page_size=16, kv_dtype=kv_dtype),
                      macro_steps=K, seed=0)
    return eng, serve.make_requests(cfg, args)


def _serve_on_card(eng, reqs):
    """Serve ``reqs``; returns (sorted results, launches of the run)."""
    for r in reqs:
        eng.submit(r)
    ops.reset_launches()
    with torch.inference_mode():
        res = sorted(eng.run(), key=lambda r: r.uid)
    torch.cuda.synchronize()
    return res, dict(ops.LAUNCHES)


def _state_tensors(eng):
    st = eng.state
    out = {k: getattr(st, k) for k in vars(st) if k != "cache"}
    out.update({f"cache.{k}": v for k, v in st.cache.items()})
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m",
                                  "llava-1.5-7b"])
def test_graph_macro_step_equals_eager_on_card(gen, arch):
    """``paged_cuda`` with K 8, every launch a replay of the one captured
    graph, against the same body run eagerly on the card: equal streams,
    the same kernel launch counts, and a bitwise equal final state (so
    nothing, cuBLAS's choices included, computes otherwise under
    capture). The eager legacy loop (K 0) gives the same CAMD streams."""
    runs = {}
    for name, K in (("graph", 8), ("eager body", 8), ("legacy", 0)):
        eng, reqs = _engine_on_card(arch, K)
        if name == "eager body":
            def eager(eng=eng):
                eng._fill_noise(eng._t)
                return eng._macro_step()
            eng._macro_launch = eager
        res, launches = _serve_on_card(eng, reqs)
        runs[name] = (eng, [[c["tokens"].tolist() for c in r.candidates]
                            for r in res], launches)
        eng.pool.check()
        assert eng.pool.in_use == 0
    eng, streams, launches = runs["graph"]
    assert eng._graphs_captured == 1 and eng._capture_s > 0
    assert eng.macro_launches > 1 and launches["paged_decode_attention"] > 0
    assert sum(eng._warmup_launches.values()) == \
        sum(eng._graph_launches.values()) > 0
    eager, e_streams, e_launches = runs["eager body"]
    assert eager._graphs_captured == 0
    assert streams == e_streams == runs["legacy"][1]
    assert launches == e_launches
    a, b = _state_tensors(eng), _state_tensors(eager)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
def test_recurrent_graph_equals_eager_on_card(gen, arch):
    """The recurrent (SSD) and hybrid (RG-LRU + local attention) models
    through ``cuda`` with K 4, every launch a replay of the one captured
    graph, whose decode writes the recurrent state in place: the same
    CAMD streams and launch counts as the body run eagerly and as the
    legacy loop, a bitwise equal final state, and the state arena empty
    at the end."""
    runs = {}
    for name, K in (("graph", 4), ("eager body", 4), ("legacy", 0)):
        eng, reqs = _engine_on_card(arch, K, impl="cuda")
        if name == "eager body":
            def eager(eng=eng):
                eng._fill_noise(eng._t)
                return eng._macro_step()
            eng._macro_launch = eager
        res, launches = _serve_on_card(eng, reqs)
        runs[name] = (eng, [[c["tokens"].tolist() for c in r.candidates]
                            for r in res], launches)
        eng.arena.check()
        assert eng.arena.in_use == 0
    eng, streams, launches = runs["graph"]
    assert eng._graphs_captured == 1 and eng.macro_launches > 1
    eager, e_streams, e_launches = runs["eager body"]
    assert streams == e_streams == runs["legacy"][1]
    assert launches == e_launches
    assert (launches["decode_attention"] > 0) == (arch != "mamba2-780m")
    a, b = _state_tensors(eng), _state_tensors(eager)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["torch", "cuda", "paged", "paged_cuda"])
def test_graph_captures_every_impl_on_card(gen, impl):
    """The body captures under every impl on the MoE config with the full
    sampling-processor chain (top-k, top-p, min-p, repetition penalty):
    no host sync in the warm-up (``set_sync_debug_mode("error")``) or the
    capture, one graph an engine."""
    chain = SamplingConfig(max_new_tokens=8, top_k=5, top_p=0.8, min_p=0.05,
                           repetition_penalty=1.2)
    eng, reqs = _engine_on_card("granite-moe-3b-a800m", 4, impl=impl,
                                sampling=chain)
    res, launches = _serve_on_card(eng, reqs)
    assert len(res) == 4 and all(r.n_candidates > 0 for r in res)
    assert eng._graphs_captured == 1
    kernels = impl.endswith("cuda")
    assert (launches["moe_dispatch"] > 0) == kernels
    assert (sum(launches.values()) > 0) == kernels


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_pool_engine_on_card(gen, kv_dtype):
    """An int8/fp8-pool engine serves through the graph on K1's dequant
    path and returns every page."""
    eng, reqs = _engine_on_card("qwen3-0.6b", 8, kv_dtype=kv_dtype)
    res, launches = _serve_on_card(eng, reqs)
    assert len(res) == 4 and all(r.n_candidates > 0 for r in res)
    assert "k_scale" in eng.state.cache and eng._graphs_captured == 1
    assert launches["paged_decode_attention"] > 0
    eng.pool.check()
    assert eng.pool.in_use == 0 and eng._reserved == 0
    assert eng.kv_stats()["kv_dtype"] == kv_dtype


@pytest.mark.gpu
@pytest.mark.parametrize("arch,flags", [
    ("qwen3-0.6b", dict(prefix_cache=True, prefill_chunk=16)),
    ("llava-1.5-7b", dict(prefix_cache=True)),
])
def test_prefix_cache_engine_on_card_equals_cpu(gen, arch, flags):
    """The reduced config with the prefix cache (qwen3 also with chunks of
    16) through ``paged_cuda`` on the card, every macro launch a replay of
    the graph captured after a warm-up under
    ``set_sync_debug_mode("error")``, against ``paged`` on the CPU with the
    same weights, over two waves of the same requests (the second hits the
    pages the first cached; llava's repeated images hit within a wave):
    equal greedy streams, prefix-cache stats and chunk calls, and every
    page back after ``drop_all``."""
    cfg = get_config(arch).reduced().with_overrides(dtype="float32")
    cpu = build_model(cfg, torch.float32, device="cpu", seed=0)
    card = build_model(cfg, torch.float32, device="cuda", seed=0)
    card.load_state_dict(cpu.state_dict())
    args = serve.parse_args(["--arch", arch, "--requests", "4",
                             "--prompt-len", "40", "--seed", "0"])
    runs = {}
    for model, impl in ((cpu, "paged"), (card, "paged_cuda")):
        eng = ServeEngine(model, slots=8, cache_len=96, mode="greedy",
                          sampling=SamplingConfig(max_new_tokens=8),
                          max_new_tokens=8, eos_id=cfg.vocab_size,
                          impl=impl, paged_kv=PagedKVConfig(page_size=8),
                          macro_steps=8, seed=0, **flags)
        ops.reset_launches()
        with torch.inference_mode():
            for w in range(2):
                for r in serve.make_requests(cfg, args):
                    eng.submit(Request(uid=100 * w + r.uid, prompt=r.prompt,
                                       image=r.image))
                res = sorted(eng.run(), key=lambda r: r.uid)
        torch.cuda.synchronize()
        runs[impl] = ([r.tokens.tolist() for r in res],
                      eng.kv_stats()["prefix_cache"], eng.chunk_calls)
        launches = dict(ops.LAUNCHES)
        assert (launches["flash_attention"] > 0 and
                launches["paged_decode_attention"] > 0) == (impl != "paged")
        assert eng._graphs_captured == (impl != "paged")
        eng.pool.prefix.drop_all()
        eng.pool.check()
        assert eng.pool.in_use == 0 and eng._reserved == 0
    assert runs["paged_cuda"] == runs["paged"]
    streams, pc, chunks = runs["paged"]
    assert len(streams) == 8 and pc["hits"] > 0
    assert (chunks > 0) == ("prefill_chunk" in flags)

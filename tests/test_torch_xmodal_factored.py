"""Why the port's cross-modal mean kernel (K4a) may sum in factored form.

K4a (``src/repro_torch/kernels/csrc/xmodal_score.cu``) computes the masked
token-visual cosine sum of paper Eq. 8

    sum1 = sum_t m_t sum_j cos(tok_t, vis_j)

without forming a single token-visual dot product: with inv_x =
1 / max(|x|, 1e-8), the sum factors exactly as sum_t m_t inv_t (tok_t . u),
u = sum_j inv_j vis_j. The card cannot run here, so these tests emulate the
kernel's fp32 arithmetic in numpy, in its order:

- pass 1 (``xmodal_mean_kernel_inv``): 128 threads share a row, each
  summing the squares of its 16-byte vectors (4 fp32 values) with fused
  multiply-adds in load order; each warp folds its lanes by a butterfly,
  the row's four warps are summed in warp order;
- pass 2 (``xmodal_mean_kernel_sum``), per 32-column chunk of d (lane l
  owns column l): warp w of 32 accumulates inv_j vis_j[c] over j = w
  (mod 32) in increasing j; u[c] is the warps' shares summed in warp
  order; warp w takes the tokens t = w (mod 32), the chunk's dot
  tok_t[c] u[c] folded by a butterfly, added as m_t (inv_t dot); the
  chunk's sum is the warps' in warp order, and the last block sums the
  chunks' sums in chunk order (one a thread, a butterfly a warp, the
  warps in order).

The emulated S_align, with K4b's plain term, is held against the JAX
package's Pallas kernel (``repro.kernels.xmodal_score.xmodal_score`` in
interpret mode) and its oracle (``repro.kernels.ref.xmodal_score_ref``) at
the port's fp32 tolerance, 1e-4 + 1e-4 |ref| (``chip_smoke.py``), and
sum1 against the unfactored sum taken in float64. Fused multiply-adds are
emulated as a float64 product and sum rounded once to fp32. The kernel
itself is held against its plain version on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.xmodal_score import xmodal_score as pallas_xmodal
from repro_torch.kernels import ref
from torch_ranks import _one_torch_thread  # noqa: F401

ATOL, RTOL = 1e-4, 1e-4          # chip_smoke.TOL["float32"]
EPS = np.float32(1e-8)
# csrc/xmodal_score.cu
ROW_THREADS, INV_UNROLL = 128, 8      # XA_ROW_THREADS, XA_INV_UNROLL
COLS, WARPS, UNROLL = 32, 32, 18      # XA_COLS, XA_WARPS, XA_UNROLL
F32 = np.float32


def fma(a, b, c):
    """fp32 a * b + c with one rounding (the product is exact in float64)."""
    return (np.float64(1) * a * b + c).astype(F32)


def butterfly(v):
    """warp_sum over the last axis (32 lanes): xor 16, 8, 4, 2, 1; every
    lane ends with the same value."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(F32)
    return v[..., 0]


def in_order(v):
    """Sum over the last axis from 0 in index order, in fp32."""
    t = np.zeros(v.shape[:-1], F32)
    for i in range(v.shape[-1]):
        t = (t + v[..., i]).astype(F32)
    return t


def inv_norms(x):
    """Pass 1 for rows x (R, d): 1 / max(|x|, 1e-8) in fp32."""
    R, d = x.shape
    V = 4 if d % 4 == 0 else 1               # 16-byte loads of 4 fp32
    step = ROW_THREADS * V * INV_UNROLL
    # each thread's elements in its load order; past d: 0 * 0 adds 0
    order = [[c0 + u * ROW_THREADS * V + i
              for c0 in range(rt * V, d, step)
              for u in range(INV_UNROLL) for i in range(V)]
             for rt in range(ROW_THREADS)]
    n = max(len(o) for o in order)
    idx = np.array([o + [d] * (n - len(o)) for o in order])   # (128, n)
    xp = np.concatenate([x, np.zeros((R, 1), F32)], axis=1)
    sq = np.zeros((R, ROW_THREADS), F32)
    for s in range(n):
        e = np.where(idx[:, s] < d, xp[:, np.minimum(idx[:, s], d)], F32(0))
        sq = fma(e, e, sq)
    warps = butterfly(sq.reshape(R, ROW_THREADS // 32, 32))
    t = in_order(warps)
    return (F32(1) / np.maximum(np.sqrt(t), EPS)).astype(F32)


def emulated_sum1(tok, mask, vis):
    """K4a's factored sum1 (B,) in the kernel's order."""
    B, L, d = tok.shape
    Nv = vis.shape[1]
    inv = inv_norms(np.concatenate([tok.reshape(B * L, d),
                                    vis.reshape(B * Nv, d)]))
    inv_t, inv_v = inv[:B * L].reshape(B, L), inv[B * L:].reshape(B, Nv)
    chunks = -(-d // COLS)
    pad = chunks * COLS - d                  # lanes past d load 0
    out = np.zeros(B, F32)
    for b in range(B):
        v = np.pad(vis[b], ((0, 0), (0, pad)))
        acc = np.zeros((WARPS, chunks * COLS), F32)
        for s in range(-(-Nv // WARPS)):     # warp w: j = w + 32 s
            j = np.arange(WARPS) + WARPS * s
            ok = j < Nv
            w_j = np.where(ok, inv_v[b, np.minimum(j, Nv - 1)], F32(0))
            x_j = np.where(ok[:, None], v[np.minimum(j, Nv - 1)], F32(0))
            acc = fma(w_j[:, None], x_j, acc)
        u = in_order(acc.T)                  # (chunks * COLS,) warp order
        tk = np.pad(tok[b], ((0, 0), (0, pad)))
        dots = butterfly((tk * u).astype(F32).reshape(L, chunks, COLS))
        s_w = np.zeros((WARPS, chunks), F32)
        for t in range(L):                   # warp t % 32, in t order
            s_w[t % WARPS] = fma(mask[b, t], (inv_t[b, t] * dots[t])
                                 .astype(F32), s_w[t % WARPS])
        part = in_order(s_w.T)               # (chunks,)
        # last block: thread i holds chunk i, butterfly a warp, warps in
        # order (chunks <= 1024 threads here)
        assert chunks <= WARPS * 32
        lanes = np.zeros(WARPS * 32, F32)
        lanes[:chunks] = part
        out[b] = in_order(butterfly(lanes.reshape(WARPS, 32)))
    return out


def emulated_s_align(tok, mask, vis, txt):
    """S_align as ``ops.xmodal_score`` forms it: K4a's emulated sum1 and
    K4b's plain sum2."""
    Nv, Nt = vis.shape[1], txt.shape[1]
    sum1 = emulated_sum1(tok, mask, vis)
    sum2 = ref.xmodal_max_sum_ref(torch.from_numpy(txt),
                                  torch.from_numpy(vis)).numpy()
    n_tok = np.maximum(mask.sum(-1, dtype=F32), F32(1))
    return (F32(0.5) * (sum1 / (n_tok * F32(Nv)) + sum2 / F32(Nt))
            ).astype(F32), sum1


def inputs(B, L, Nv, Nt, d, seed):
    """As ``chip_smoke.xmodal_phase``: strong text-visual matches, 70% of
    tokens live; with B > 1 a row with no live token, a zero token row and
    a zero visual row."""
    rng = np.random.default_rng(seed)
    tok, vis, txt = (rng.standard_normal((B, n, d)).astype(F32)
                     for n in (L, Nv, Nt))
    k = min(Nv, Nt)
    vis[:, :k] += 2 * txt[:, :k]
    mask = (rng.uniform(size=(B, L)) < 0.7).astype(F32)
    if B > 1:
        mask[-1] = 0.0
        tok[0, -1] = 0.0
        vis[0, 1] = 0.0
    return tok, mask, vis, txt


def unfactored_sum1(tok, mask, vis):
    """sum_t m_t sum_j cos(tok_t, vis_j) in float64."""
    def unit(x):
        x = x.astype(np.float64)
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                              1e-8)
    return np.einsum("bl,bld,bnd->b", mask.astype(np.float64), unit(tok),
                     unit(vis))


@pytest.mark.parametrize("B,L,Nv,Nt,d", [
    (1, 32, 576, 256, 4096),     # llava's serving shape
    (3, 1, 7, 129, 48),          # ragged rows, d not a chunk multiple
    (2, 33, 65, 31, 100),
    (2, 5, 40, 9, 4096),         # a zero row and a row with no live token
])
def test_factored_sum_matches_reference(B, L, Nv, Nt, d):
    tok, mask, vis, txt = inputs(B, L, Nv, Nt, d, seed=B * 1000 + d)
    out, sum1 = emulated_s_align(tok, mask, vis, txt)
    args = (jnp.asarray(tok), jnp.asarray(mask), jnp.asarray(vis),
            jnp.asarray(txt))
    for exp in (np.asarray(pallas_xmodal(*args, interpret=True)),
                np.asarray(jref.xmodal_score_ref(*args))):
        np.testing.assert_allclose(out, exp, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sum1, unfactored_sum1(tok, mask, vis),
                               rtol=RTOL, atol=ATOL)
    if B > 1:                    # the row with no live token adds exactly 0
        assert sum1[-1] == 0.0


def test_zero_rows_add_nothing():
    """A zero row's inverse norm is 1e8 (the norm's 1e-8 floor), and its
    terms are exactly 0: zeroing a token or visual row changes sum1 as
    dropping it from the sum does."""
    tok, mask, vis, _ = inputs(1, 8, 24, 4, 64, seed=5)
    mask[:] = 1.0
    assert inv_norms(np.zeros((1, 64), F32))[0] == F32(1e8)
    zt, zv = tok.copy(), vis.copy()
    zt[0, 3] = 0.0
    zv[0, 7] = 0.0
    keep_t = np.arange(8) != 3
    keep_v = np.arange(24) != 7
    np.testing.assert_allclose(
        emulated_sum1(zt, mask, zv),
        unfactored_sum1(tok[:, keep_t], mask[:, keep_t], vis[:, keep_v]),
        rtol=RTOL, atol=ATOL)

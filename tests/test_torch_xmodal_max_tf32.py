"""The port's cross-modal max kernel (K4b) in 3xTF32 with a split over d.

K4b (``src/repro_torch/kernels/csrc/xmodal_score.cu``, ``xmodal_max_kernel``)
computes the second sum of paper Eq. 9,

    sum2 = sum_r max_j cos(txt_r, vis_j),

on the H100's tensor cores, which take fp32 only as TF32. For fp32 it
splits each operand as hi = tf32(x), rounded to nearest with ties away
from zero as ``cvt.rna.tf32.f32`` rounds, and lo = x - hi, which the
tensor core reads as TF32 by dropping its low 13 bits, and sums
lo*hi + hi*lo + hi*hi in fp32; bf16 values are exact in TF32 and take the
hi pass alone. d is cut into splits by ``ops.xmodal_max_splits`` (planned
here for the H100's 132 SMs). The card cannot run here, so these tests
emulate that arithmetic in numpy, in the kernel's order where the order
is the kernel's own:

- per split, the partial dot products (3xTF32 or one pass, fp32
  accumulation; the tensor core's order inside a product is not
  emulated) and the squared norms of both row sets: lane t of a
  fragment quad takes columns 16 c + 4 t + i of each 32-column chunk
  (c = 0, 1; i = 0..3) by fused multiply-adds in that order, and the
  quad's four sums fold as (l0 + l1) + (l2 + l3);
- the tile's last block sums the splits' dots and squared norms in split
  order from 0, takes inv = 1 / max(sqrt(n2), 1e-8), cos = (dot inv_r)
  inv_j, and each text row's max over the visual rows;
- the batch row's last tile sums the rows' maxima: thread i of 128 takes
  rows i, i + 128, ... in order, a butterfly over each warp, the four
  warps' sums in warp order.

The emulated sum2 forms S_align with the JAX package's own K4a term and is
held against the JAX package's Pallas kernel
(``repro.kernels.xmodal_score.xmodal_score`` in interpret mode) and its
oracle (``repro.kernels.ref.xmodal_score_ref``) at the port's fp32
tolerance, 1e-4 + 1e-4 |ref| (``chip_smoke.py``), and each row's max
against float64. Fused multiply-adds are emulated as a float64 product
and sum rounded once to fp32. The kernel itself is held against its plain
version on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.xmodal_score import xmodal_score as pallas_xmodal
from repro_torch.kernels import ops
from torch_ranks import _one_torch_thread  # noqa: F401

ATOL, RTOL = 1e-4, 1e-4          # chip_smoke.TOL["float32"]
EPS = np.float32(1e-8)
SMS = 132                        # the H100's SMs
THREADS = 128                    # XM_THREADS: the last tile's row sum
F32 = np.float32
MASK = np.uint32(0xFFFFE000)     # the bits TF32 keeps of an fp32 value


def tf32(x):
    """x rounded as cvt.rna.tf32.f32 rounds it: the low 13 mantissa bits
    cleared, to nearest with ties away from zero (finite inputs)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & MASK).view(np.float32)


def tf32_trunc(x):
    """x as the tensor core reads an fp32 operand: low 13 bits dropped."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (u & MASK).view(np.float32)


def mm(a, b, passes):
    """a @ b.T with fp32 accumulation: one pass of exact operands
    (passes 0: bf16 values, exact in TF32), one TF32 pass (1) or 3xTF32
    (3)."""
    if passes == 0:
        return np.matmul(a, b.T).astype(F32)
    a_hi, b_hi = tf32(a), tf32(b)
    out = np.matmul(a_hi, b_hi.T)
    if passes == 3:
        a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
        out = np.matmul(a_lo, b_hi.T) + np.matmul(a_hi, b_lo.T) + out
    return out.astype(F32)


def fma(a, b, c):
    """fp32 a * b + c with one rounding (the product is exact in float64)."""
    return (np.float64(1) * a * b + c).astype(F32)


def split_squares(x, k_beg, k_end):
    """Squared norms of rows x (R, d) over columns [k_beg, k_end) as a
    fragment quad sums them: lane t's fused multiply-adds over its
    columns in chunk order, then (l0 + l1) + (l2 + l3)."""
    lanes = []
    for t in range(4):
        acc = np.zeros(x.shape[0], F32)
        for k0 in range(k_beg, k_end, ops.XM_KC):
            for c in (0, 1):
                for i in range(4):
                    col = k0 + 16 * c + 4 * t + i
                    if col < k_end:          # past it: zeros, adding 0
                        acc = fma(x[:, col], x[:, col], acc)
        lanes.append(acc)
    return ((lanes[0] + lanes[1]).astype(F32) +
            (lanes[2] + lanes[3]).astype(F32)).astype(F32)


def butterfly(v):
    """warp_sum over the last axis (32 lanes): xor 16, 8, 4, 2, 1."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(F32)
    return v[..., 0]


def emulated_k4b(txt, vis, passes):
    """K4b's sum2 (B,) and each text row's max (B, Nt), in the kernel's
    split plan and fold order."""
    B, Nt, d = txt.shape
    Nv = vis.shape[1]
    n_split, cols = ops.xmodal_max_splits(B, Nt, Nv, d, SMS)
    sums, maxima = np.zeros(B, F32), np.zeros((B, Nt), F32)
    for b in range(B):
        dot = np.zeros((Nt, Nv), F32)
        n2_t, n2_v = np.zeros(Nt, F32), np.zeros(Nv, F32)
        for s in range(n_split):             # split order, from 0
            k_beg, k_end = s * cols, min(d, (s + 1) * cols)
            dot = (dot + mm(txt[b, :, k_beg:k_end], vis[b, :, k_beg:k_end],
                            passes)).astype(F32)
            n2_t = (n2_t + split_squares(txt[b], k_beg, k_end)).astype(F32)
            n2_v = (n2_v + split_squares(vis[b], k_beg, k_end)).astype(F32)
        inv_t = (F32(1) / np.maximum(np.sqrt(n2_t), EPS)).astype(F32)
        inv_v = (F32(1) / np.maximum(np.sqrt(n2_v), EPS)).astype(F32)
        cos = ((dot * inv_t[:, None]).astype(F32) * inv_v[None, :]).astype(
            F32)
        maxima[b] = cos.max(-1)
        rows = np.zeros(-(-Nt // THREADS) * THREADS, F32)
        rows[:Nt] = maxima[b]
        per_thread = np.zeros(THREADS, F32)
        for k in range(len(rows) // THREADS):    # rows i, i + 128, ...
            per_thread = (per_thread + rows[k * THREADS:(k + 1) * THREADS]
                          ).astype(F32)
        warps = butterfly(per_thread.reshape(THREADS // 32, 32))
        total = F32(0)
        for w in warps:                          # warp order
            total = F32(total + w)
        sums[b] = total
    return sums, maxima


def row_maxima_f64(txt, vis):
    def unit(x):
        x = x.astype(np.float64)
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True),
                              1e-8)
    return np.einsum("brd,bnd->brn", unit(txt), unit(vis)).max(-1)


def inputs(B, L, Nv, Nt, d, seed, dtype):
    """As ``chip_smoke.xmodal_phase``: strong text-visual matches, 70% of
    tokens live; with B > 1 a zero token, visual and text row. In bf16
    every value is rounded to bf16 (held in fp32: the kernel computes in
    fp32 from the same values)."""
    rng = np.random.default_rng(seed)
    tok, vis, txt = (rng.standard_normal((B, n, d)).astype(F32)
                     for n in (L, Nv, Nt))
    k = min(Nv, Nt)
    vis[:, :k] += 2 * txt[:, :k]
    mask = (rng.uniform(size=(B, L)) < 0.7).astype(F32)
    if B > 1:
        tok[0, -1] = 0.0
        vis[0, 1] = 0.0
        txt[0, min(2, Nt - 1)] = 0.0
    if dtype == "bfloat16":
        tok, vis, txt = (torch.from_numpy(x).bfloat16().float().numpy()
                         for x in (tok, vis, txt))
    return tok, mask, vis, txt


def s_align(tok, mask, vis, txt, sum2, fn):
    """S_align from ``fn``'s own K4a term and ``sum2``: with no live token
    term 1 is 0, so fn(mask) - fn(0) is fn's 0.5 term1."""
    args = [jnp.asarray(x) for x in (tok, mask, vis, txt)]
    exp = np.asarray(fn(*args))
    args[1] = jnp.zeros_like(args[1])
    half_t1 = (exp - np.asarray(fn(*args))).astype(F32)
    return (half_t1 + F32(0.5) * sum2 / F32(txt.shape[1])).astype(F32), exp


SHAPES = [  # (B, L, Nv, Nt, d)
    (1, 32, 576, 256, 4096),     # llava's serving shape: 7 splits
    (3, 1, 7, 129, 48),          # ragged rows, d not a chunk multiple: 1
    (2, 33, 65, 31, 100),        # one split
    (2, 8, 100, 70, 1004),       # ragged everything under 8 splits
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,Nv,Nt,d", SHAPES)
def test_emulated_k4b_matches_reference(dtype, B, L, Nv, Nt, d):
    tok, mask, vis, txt = inputs(B, L, Nv, Nt, d, seed=B * 1000 + d,
                                 dtype=dtype)
    passes = 3 if dtype == "float32" else 0
    sum2, maxima = emulated_k4b(txt, vis, passes)
    for fn in (lambda *a: pallas_xmodal(*a, interpret=True),
               jref.xmodal_score_ref):
        out, exp = s_align(tok, mask, vis, txt, sum2, fn)
        np.testing.assert_allclose(out, exp, rtol=RTOL, atol=ATOL)
    exact = row_maxima_f64(txt, vis)
    np.testing.assert_allclose(maxima, exact, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sum2, exact.sum(-1), rtol=RTOL, atol=ATOL)
    if B > 1:                    # a zero text row's best cosine is 0
        assert maxima[0, min(2, Nt - 1)] == 0.0


def test_near_tie_takes_the_larger():
    """A text row whose two best visual rows differ in cosine by ~1e-6:
    the emulated max stays within 1e-6 of the larger, and sum2 within
    the tolerance of the reference."""
    B, L, Nv, Nt, d = 1, 4, 96, 80, 512
    tok, mask, vis, txt = inputs(B, L, Nv, Nt, d, seed=11, dtype="float32")
    rng = np.random.default_rng(12)
    vis[0, 40] = txt[0, 5] + 0.3 * rng.standard_normal(d).astype(F32)
    vis[0, 41] = vis[0, 40] + 1e-5 * rng.standard_normal(d).astype(F32)
    unit = vis[0, 40:42].astype(np.float64)
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    t5 = txt[0, 5].astype(np.float64) / np.linalg.norm(txt[0, 5])
    gap = abs(unit[0] @ t5 - unit[1] @ t5)
    assert 0 < gap < 1e-5
    sum2, maxima = emulated_k4b(txt, vis, 3)
    exact = row_maxima_f64(txt, vis)
    assert abs(maxima[0, 5] - exact[0, 5]) < 1e-6
    for fn in (lambda *a: pallas_xmodal(*a, interpret=True),
               jref.xmodal_score_ref):
        out, exp = s_align(tok, mask, vis, txt, sum2, fn)
        np.testing.assert_allclose(out, exp, rtol=RTOL, atol=ATOL)


def test_one_tf32_pass_error_at_the_serving_shape():
    """On record, not asserted: how far one TF32 pass on fp32 inputs lies
    from float64 at the serving shape, beside 3xTF32."""
    B, L, Nv, Nt, d = SHAPES[0]
    _, _, vis, txt = inputs(B, L, Nv, Nt, d, seed=B * 1000 + d,
                            dtype="float32")
    exact = row_maxima_f64(txt, vis)
    for passes in (3, 1):
        sum2, maxima = emulated_k4b(txt, vis, passes)
        print(f"K4b {'3xTF32' if passes == 3 else 'one TF32 pass'}: row "
              f"max error {np.abs(maxima - exact).max():.3e}, S_align's "
              f"term 2 error "
              f"{abs(sum2[0] - exact.sum()) / Nt:.3e} (fp32 tolerance "
              f"{ATOL:g} + {RTOL:g}|ref|)")
        assert np.isfinite(sum2).all()


def _fill(tiles, n):
    """How full the last wave of ``tiles * n`` blocks is, a block an SM."""
    blocks = tiles * n
    return blocks / (-(-blocks // SMS) * SMS)


@pytest.mark.parametrize("B,Nt,Nv,d", [
    (1, 256, 576, 4096), (8, 256, 576, 4096), (1, 8, 8, 4096),
    (1, 32, 576, 4096), (3, 129, 7, 48), (2, 70, 100, 1004),
    (1, 256, 576, 100), (4, 1, 1, 1)])
def test_split_plan(B, Nt, Nv, d):
    """Splits cover d in whole chunks, none empty, each at least
    XM_MIN_CHUNKS chunks where there are two or more; the plan takes the
    fewest splits whose last wave of blocks is XM_WAVE_FILL full (the
    serving shape's 36 tiles: 7 splits, 252 blocks on 2 x 132 SMs), else the
    fullest; a short d takes one split."""
    n, cols = ops.xmodal_max_splits(B, Nt, Nv, d, SMS)
    chunks = -(-d // ops.XM_KC)
    tiles = B * -(-Nt // ops.XM_ROWS) * -(-Nv // ops.XM_COLS)
    assert cols % ops.XM_KC == 0 and (n - 1) * cols < d <= n * cols
    assert n == 1 or cols // ops.XM_KC >= ops.XM_MIN_CHUNKS
    # every plan the rule may take: n splits of ceil(chunks / n) chunks
    plans = sorted({-(-chunks // -(-chunks // k))
                    for k in range(1, max(1, chunks // ops.XM_MIN_CHUNKS) + 1)})
    fills = {k: _fill(tiles, k) for k in plans}
    if fills[n] >= ops.XM_WAVE_FILL:
        assert all(fills[k] < ops.XM_WAVE_FILL for k in plans if k < n)
    else:
        assert fills[n] == max(fills.values())
    if (B, Nt, Nv, d) == (1, 256, 576, 4096):
        assert (n, cols) == (7, 608) and tiles * n == 252
    if chunks < 2 * ops.XM_MIN_CHUNKS:
        assert n == 1


def test_max_wrapper_reads_no_device_value(monkeypatch):
    """The card path of the K4b wrapper, driven with tensors that claim to
    lie on the card but hold no data (meta tensors): it plans from shapes,
    sizes the workspace and hands the C entry point one argument per
    declared parameter, without reading any value."""
    from repro_torch.kernels import build

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    def empty(*shape, dtype=torch.float32):
        return torch.Tensor._make_subclass(
            OnCard, torch.empty(shape, dtype=dtype, device="meta"))

    launched, made = [], []
    monkeypatch.setattr(ops, "_sms", lambda t: SMS)
    monkeypatch.setattr(ops, "_xmodal_tickets",
                        lambda dev, n: made.append(n) or empty(n))
    monkeypatch.setattr(ops, "_launch",
                        lambda name, *args: launched.append((name, args)))
    B, Nt, Nv, d = 1, 256, 576, 4096
    out = ops.xmodal_max_sum(empty(B, Nt, d), empty(B, Nv, d))
    assert out.shape == (B,) and out.device.type == "meta"
    (name, args), = launched
    assert name == "xmodal_score_max"
    assert len(args) == len(build.KERNELS[name][1]) - 1   # and the stream
    assert args[-3:-1] == (7, 608)
    assert made == [B * 36 + B]                # a ticket a tile, one a row
    # 36 tiles x 7 splits of (64 x 64 dots + 128 norms), 9 x 256 maxima
    assert ops._xmodal_max_work(B, Nt, Nv, 7) == 36 * 7 * 4224 + 9 * 256

"""Why the port's prefill attention kernel (K2) splits fp32 into 3xTF32.

K2 (``src/repro_torch/kernels/csrc/flash_attention.cu``) runs both of its
products, S = Q K^T and O = P V, on the H100's tensor cores, which take
fp32 only as TF32, 10 of the 23 mantissa bits. For fp32 the kernel splits
each operand as hi = tf32(x), rounded to nearest with ties away from zero
as ``cvt.rna.tf32.f32`` rounds, and lo = x - hi, which the tensor core
reads as TF32 by dropping its low 13 bits, and sums lo*hi + hi*lo + hi*hi
in fp32. The card cannot run here, so these tests emulate that arithmetic
in numpy, push it through a plain causal attention laid out as the kernel
computes it (unscaled scores, p = 2^((s - m) hd^-0.5 log2 e), the sum of
the unnormalised P V divided by the row sum at the end), and hold it
against the JAX package's ``repro.kernels.ref.flash_attention_ref`` on the
same numpy inputs. The port's fp32 tolerance, 1e-4 + 1e-4 |ref|
(``chip_smoke.py``), must hold for 3xTF32 and must fail for a single TF32
pass: that pins why the kernel splits. The kernel itself is held against
its plain version on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ref as jref
from torch_ranks import _one_torch_thread  # noqa: F401

ATOL, RTOL = 1e-4, 1e-4     # chip_smoke.TOL["float32"]


MASK = np.uint32(0xFFFFE000)       # the bits TF32 keeps of an fp32 value


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
    """a @ b over the last two axes with fp32 accumulation: one TF32 pass
    (passes == 1) or 3xTF32 (passes == 3)."""
    a_hi, b_hi = tf32(a), tf32(b)
    out = np.matmul(a_hi, b_hi)
    if passes == 3:
        a_lo, b_lo = tf32_trunc(a - a_hi), tf32_trunc(b - b_hi)
        out = np.matmul(a_lo, b_hi) + np.matmul(a_hi, b_lo) + out
    return out.astype(np.float32)


def emulated_attention(q, k, v, passes):
    """Causal attention with K2's arithmetic. q: (B, L, H, hd); k/v:
    (B, L, Hkv, hd) grouped. Returns (B, L, H, hd) fp32."""
    B, L, H, hd = q.shape
    rep = H // k.shape[2]
    qh = q.transpose(0, 2, 1, 3)                               # (B, H, L, hd)
    kh = np.repeat(k, rep, axis=2).transpose(0, 2, 1, 3)
    vh = np.repeat(v, rep, axis=2).transpose(0, 2, 1, 3)
    s = mm(qh, kh.transpose(0, 1, 3, 2), passes)               # unscaled
    s = np.where(np.tril(np.ones((L, L), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    c = np.float32(np.log2(np.e) / np.sqrt(hd))
    p = np.exp2((s - m) * c).astype(np.float32)
    out = mm(p, vh, passes) / p.sum(-1, keepdims=True, dtype=np.float32)
    return out.transpose(0, 2, 1, 3)


def beyond(out, exp):
    """Share of elements outside ATOL + RTOL |exp|, and the max error."""
    err = np.abs(out - exp)
    return float((err > ATOL + RTOL * np.abs(exp)).mean()), float(err.max())


def test_tf32_rounding_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10                 # TF32's unit in the last place at 1
    x = np.array([1 + 2 ** -11, 1 + 2 ** -12, 1 + 3 * 2 ** -11,
                  -(1 + 2 ** -11), 1 + ulp, 3.0, 1 + 2 ** -11 + 2 ** -20],
                 np.float32)
    want = np.array([1 + ulp, 1, 1 + 2 * ulp, -(1 + ulp), 1 + ulp, 3.0,
                     1 + ulp], np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    np.testing.assert_array_equal(tf32_trunc(x[:4]),
                                  np.array([1, 1, 1 + ulp, -1], np.float32))
    # hi + lo, lo truncated, keeps 21 or more of the 24 significant bits
    r = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    hi = tf32(r)
    rel = np.abs((hi + tf32_trunc(r - hi)) - r) / np.abs(r)
    assert rel.max() <= 2.0 ** -21
    # hi alone keeps only 11: its error reaches past 2^-12 of the value
    assert (np.abs(hi - r) / np.abs(r)).max() > 2.0 ** -12


@pytest.mark.parametrize("B,L,H,Hkv,hd", [
    (1, 256, 16, 8, 128),      # qwen3's heads at its serving prompt
    (1, 1024, 2, 1, 16),       # long rows at every head_dim K2 takes
    (1, 1024, 2, 1, 32),
    (1, 1024, 2, 1, 64),
    (1, 2048, 1, 1, 128),
])
def test_3xtf32_meets_fp32_tolerance_and_one_pass_does_not(B, L, H, Hkv,
                                                           hd):
    rng = np.random.default_rng(L + hd)
    q = rng.standard_normal((B, L, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, L, Hkv, hd), dtype=np.float32)
    v = rng.standard_normal((B, L, Hkv, hd), dtype=np.float32)
    rep = H // Hkv
    exp = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=2)),
        jnp.asarray(np.repeat(v, rep, axis=2)), causal=True), np.float32)
    frac3, err3 = beyond(emulated_attention(q, k, v, 3), exp)
    frac1, err1 = beyond(emulated_attention(q, k, v, 1), exp)
    assert frac3 == 0.0, f"3xTF32: max error {err3:.2e}"
    assert err3 < 1e-5
    assert frac1 > 0.0 and err1 > 10 * err3, \
        f"one TF32 pass: {frac1:.3%} beyond, max error {err1:.2e}"

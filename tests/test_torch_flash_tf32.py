"""The fp32 attention forward on 3xTF32 ``wgmma``
(``csrc/flash_fwd_tf32_sm90.cu``), held on the CPU: which kernel each
forward call takes (``flash_attention.route``), a plain-PyTorch emulation
of the kernel's arithmetic (operands split into tf32 hi and lo parts, three
products summed in fp32, the kernel's softmax points) against the JAX
package's Pallas kernels (interpret mode, as the JAX package's own tests
run them) on the same numpy inputs, the index algebra that carries P from
the score registers to the product's A registers, and what the wrapper
hands its launcher.  The kernel itself meets the plain versions on the
card in ``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.ops import flash_attention as jflash
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.ops import flash_attention as tflash
from sdbc_tpu_torch.ops import flash_tf32
from tests.torch_threads import one_thread  # noqa: F401

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# The emulation against the JAX kernels' fp32: the split product loses
# ~2^-21 of each score (a_lo.b_lo and the rounding of the lo parts), and
# the sums run in other orders; 1e-5 of the largest output entry.  LSE in
# absolute terms (natural-log units, |lse| ~ 10).
REL_TOL, LSE_ATOL = 1e-5, 1e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the route: dtype × head dim × fixed cap or training forward → kernel

BF, F32 = torch.bfloat16, torch.float32
ROUTES = [
    (BF, 8, "flash_{}"), (BF, 40, "flash_{}"), (BF, 44, "flash_{}_simt"),
    (BF, 80, "flash_{}"), (BF, 160, "flash_{}"), (BF, 256, "flash_{}"),
    (BF, 264, "flash_{}"), (BF, 512, "flash_{}"),
    (F32, 8, "flash_{}_tf32"), (F32, 40, "flash_{}_tf32"),
    (F32, 44, "flash_{}_simt"), (F32, 80, "flash_{}_tf32"),
    (F32, 160, "flash_{}_tf32"), (F32, 256, "flash_{}_tf32"),
    (F32, 264, "flash_{}_tf32"), (F32, 512, "flash_{}_tf32"),
]


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("dtype,d,want", ROUTES)
def test_route_by_dtype_and_head_dim(dtype, d, want, fixed):
    assert tflash.route(dtype, d, fixed=fixed) \
        == want.format("fixed" if fixed else "fwd")


@pytest.mark.parametrize("dtype", [torch.float16, None])
def test_route_sends_what_no_tensor_core_kernel_takes_to_simt(dtype):
    """fp16 and q/k/v of mixed dtypes (None) go to the CUDA-core kernel,
    whose check raises on them."""
    assert tflash.route(dtype, 40, fixed=True) == "flash_fixed_simt"
    assert tflash.route(dtype, 40, fixed=False) == "flash_fwd_simt"


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated


def tf32(x):
    """x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero
    (cvt.rna.tf32.f32): half a tf32 ulp added to the magnitude bits, the
    low 13 bits cleared; an fp32 tensor."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """a @ b as the kernel forms it: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi,
    each product of tf32 values exact in fp32, summed in fp32."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def fixed_cap_3xtf32(q, k, v, scale):
    """The fixed cap as the kernel computes it, over (B, H, S, D) fp32."""
    qp = q * (scale * LOG2E)
    s = mm3(qp, k.transpose(-1, -2))
    p = torch.exp2(torch.clamp(s, max=60.0))
    l = p.sum(-1, keepdim=True)
    return mm3(p, v) / torch.clamp(l, min=1e-37)


def fwd_3xtf32(q, k, v, scale):
    """(out, lse) of the training forward as the kernel computes it (the
    row max at once, which the kernel reaches tile by tile)."""
    qp = q * (scale * LOG2E)
    s = mm3(qp, k.transpose(-1, -2))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    return mm3(p, v) / l, (m * LN2 + torch.log(l))[..., 0]


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -12,
                      one + 3 * 2 ** -12, 0.0, -0.0, 2 ** -130],
                     dtype=torch.float32)
    got = tf32(x)
    want = [one + 2 ** -10, -(one + 2 ** -10), one, one + 2 ** -10, 0.0,
            -0.0, 2 ** -130]
    assert got.tolist() == want
    assert not (got.view(torch.int32) & 0x1FFF).any()


def test_split_keeps_fp32_accuracy():
    """hi + lo is x to ~2^-22; the three products to ~2^-20 of the exact
    product, where one tf32 product is off by ~2^-11."""
    a = _t(_rand(1, 64, 40))
    b = _t(_rand(2, 40, 48))
    hi, lo = split(a)
    assert ((hi + lo - a).abs() <= 2 ** -21 * a.abs()).all()
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    err3 = ((mm3(a, b).double() - exact).abs() / scale).max().item()
    err1 = ((tf32(a) @ tf32(b)).double() - exact).abs().div(scale)
    assert err3 <= 2 ** -19 and err1.max().item() >= 2 ** -13


# (b, h, sq, sk, d): the 64² level's head dim, a ragged pair at 40, the
# 32² and 16² levels' head dims, the widest head the kernel takes
CASES = [(1, 2, 256, 256, 40), (2, 2, 200, 300, 40), (1, 2, 128, 256, 80),
         (1, 1, 128, 200, 160), (1, 1, 64, 100, 256)]


def _inputs(case, seed):
    b, h, sq, sk, d = case
    return (_rand(seed, b, h, sq, d), _rand(seed + 1, b, h, sk, d),
            _rand(seed + 2, b, h, sk, d))


@pytest.mark.parametrize("case", CASES)
def test_fixed_cap_emulation_matches_jax(case):
    q, k, v = _inputs(case, 10)
    scale = case[-1] ** -0.5
    jout = np.asarray(jflash.flash_attention_fixed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out = fixed_cap_3xtf32(_t(q), _t(k), _t(v), scale).numpy()
    assert np.abs(out - jout).max() <= REL_TOL * np.abs(jout).max()


@pytest.mark.parametrize("case", CASES)
def test_fwd_emulation_matches_jax(case):
    q, k, v = _inputs(case, 20)
    scale = case[-1] ** -0.5
    jout, jlse = jflash._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), scale)
    jout, jlse = np.asarray(jout), np.asarray(jlse)
    out, lse = fwd_3xtf32(_t(q), _t(k), _t(v), scale)
    assert np.abs(out.numpy() - jout).max() <= REL_TOL * np.abs(jout).max()
    assert np.abs(lse.numpy() - jlse).max() <= LSE_ATOL


def test_emulation_matches_the_plain_versions():
    """The plain fp32 versions the card holds the kernel to
    (``fixed_cap_attention_ref``, ``flash_attention_ref``) agree with the
    emulation as closely as with the JAX kernels."""
    q, k, v = (_t(a) for a in _inputs((2, 2, 200, 300, 40), 30))
    scale = 40 ** -0.5
    ref = tflash.fixed_cap_attention_ref(q, k, v, scale)
    got = fixed_cap_3xtf32(q, k, v, scale)
    assert (got - ref).abs().max() <= REL_TOL * ref.abs().max()
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, scale)
    got, lse = fwd_3xtf32(q, k, v, scale)
    assert (got - ref).abs().max() <= REL_TOL * ref.abs().max()
    assert (lse - ref_lse).abs().max() <= LSE_ATOL


# ---------------------------------------------------------------------------
# P from the score registers to the A registers (the kernel's index algebra)


def _pi(c):
    """The key that V^T's position c of a group of 8 holds."""
    return (c % 4) * 2 + c // 4


def test_permuted_vt_carries_p_from_the_accumulator_to_the_a_fragment():
    """One warp's 16 rows and one k8 step: lane (g, t) holds S[g, 2t],
    S[g, 2t+1], S[g+8, 2t], S[g+8, 2t+1] (the m64nN accumulator) and
    passes them as a0, a2, a1, a3, which the tf32 A fragment reads as
    (g, t), (g, t+4), (g+8, t), (g+8, t+4).  With V^T's keys permuted by
    pi the product is P.V."""
    rng = np.random.default_rng(0)
    p = rng.standard_normal((16, 8))
    v = rng.standard_normal((8, 24))
    a = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        s = [p[g, 2 * t], p[g, 2 * t + 1], p[g + 8, 2 * t],
             p[g + 8, 2 * t + 1]]
        a0, a1, a2, a3 = s[0], s[2], s[1], s[3]  # gemm_pv's order
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a0, a1, a2, a3
    b = v[[_pi(c) for c in range(8)]]
    np.testing.assert_allclose(a @ b, p @ v, rtol=0, atol=1e-12)


def test_split_pass_index_formula_is_pi():
    """split_kv_kernel's source row for position c of a 32-key tile:
    (c & ~7) | ((c & 3) * 2 + ((c >> 2) & 1))."""
    rows = [(c & ~7) | ((c & 3) * 2 + ((c >> 2) & 1)) for c in range(32)]
    assert rows == [8 * (c // 8) + _pi(c % 8) for c in range(32)]
    assert sorted(rows) == list(range(32))


# ---------------------------------------------------------------------------
# the wrapper (its launcher recorded)


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(_kernels, "flash_tf32",
                        lambda *a, fixed: calls.append((a, fixed)))
    return calls


def test_fixed_cap_wrapper_hands_the_views_and_scratch(recorded):
    b, h, sq, sk, d = 2, 3, 50, 21, 40
    q = torch.zeros(b, sq, h, d).transpose(1, 2)  # projection layout
    k = torch.zeros(b, h, sk, d)
    o = torch.empty(b, sq, h, d).transpose(1, 2)
    flash_tf32.fixed_cap(q, k, k, o, 0.25)
    (qv, kv, vv, ov, lse, scratch, qscale), fixed = recorded[0]
    assert fixed and lse is None and qv is q and ov is o and kv is k
    assert scratch.dtype == torch.float32 \
        and scratch.numel() == 4 * b * h * 24 * d  # Sk rounded up to 8
    assert qscale == pytest.approx(0.25 * LOG2E)


def test_wrapper_copies_a_q_that_tma_cannot_read(recorded):
    """A q whose row stride is not a multiple of 4 floats goes as a
    contiguous copy; k and v of any strides go as they are."""
    base = torch.zeros(1, 30, 2 * 40 + 2)
    q = base[..., :80].reshape(1, 30, 2, 40).transpose(1, 2)
    assert q.stride()[2] % 4
    k = torch.zeros(1, 2, 30, 40)
    flash_tf32.fwd(q, k, k, torch.empty(1, 2, 30, 40), torch.empty(1, 2, 30),
                   1.0)
    (qv, kv, *_), fixed = recorded[0]
    assert not fixed and qv.is_contiguous() and torch.equal(qv, q)


def test_flash_fwd_gives_the_tf32_kernel_the_projection_layout(
        recorded, monkeypatch):
    """``flash_attention.flash_fwd`` on an fp32 CUDA tensor (the device
    check stubbed) allocates out in the projection layout, as for the bf16
    kernel, and a contiguous fp32 LSE, and hands both to the kernel."""
    monkeypatch.setattr(tflash, "_on_cpu", lambda t: False)
    q = torch.zeros(2, 3, 64, 40)
    out, lse = tflash.flash_fwd(q, q, q, 1.0)
    assert out.stride() == (64 * 3 * 40, 40, 3 * 40, 1)
    assert lse.shape == (2, 3, 64) and lse.dtype == torch.float32
    (_, _, _, ov, lv, _, _), fixed = recorded[0]
    assert not fixed and ov is out and lv is lse


def test_fwd_wrapper_refuses_a_wrong_lse(recorded):
    q = torch.zeros(1, 2, 16, 40)
    for lse in (torch.empty(1, 2, 16, dtype=torch.float64),
                torch.empty(1, 2, 15), torch.empty(1, 16, 2).transpose(1, 2)):
        with pytest.raises(ValueError, match="lse"):
            flash_tf32.fwd(q, q, q, torch.empty_like(q), lse, 1.0)
    assert recorded == []


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 40),
                                     (torch.float32, 44),
                                     (torch.float32, 520)])
def test_wrapper_refuses_what_the_kernel_does_not_take(recorded, dtype, d):
    q = torch.zeros(1, 1, 16, d, dtype=dtype)
    with pytest.raises(ValueError, match="flash_tf32"):
        flash_tf32.fixed_cap(q, q, q, torch.empty_like(q), 1.0)
    with pytest.raises(ValueError, match="flash_tf32"):
        flash_tf32.fwd(q, q, q, torch.empty_like(q),
                       torch.empty(1, 1, 16), 1.0)
    assert recorded == []

"""The fp32 attention forward at head dims 264-512 on 3xTF32 ``wgmma``
(``csrc/flash_fwd_tf32_wide_sm90.cu``), held on the CPU: which kernel a
forward call takes (``flash_attention.route``; the fp32 transposed layout
too), a plain-PyTorch emulation of the kernel's arithmetic (tiles of 32
keys; the scores as the sum of two partial products over the head-dim
halves that the two CTAs of a cluster hold, each split into tf32 hi and lo
parts; P.V through the permuted V^T) against the JAX package's Pallas
kernels (interpret mode, as the JAX package's own tests run them) on the
same numpy inputs at D = 512 and 264, the pieces the kernel streams, and
what the wrapper hands its launcher.  The kernel itself meets the plain
versions on the card in ``tests/test_torch_kernels.py`` and
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.ops import flash_attention as jflash
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.ops import flash_attention as tflash
from sdbc_tpu_torch.ops import flash_attention_tt as ttt
from sdbc_tpu_torch.ops import flash_tf32
from tests.torch_threads import one_thread  # noqa: F401

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# The emulation against the JAX kernels' fp32: 1e-4 of the largest output
# entry plus 1e-6 (the split products lose ~2^-21 of a score and the sums
# run in other orders); the LSE within 1e-5 (natural-log units).
REL_TOL, ABS_TOL, LSE_ATOL = 1e-4, 1e-6, 1e-5
DS, BK = 256, 32  # head-dim columns of a CTA, keys of a tile


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def tf32(x):
    """x rounded to tf32 to nearest, ties away (cvt.rna.tf32.f32)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def mm3(a, b):
    """a @ b as three tf32 products of hi and lo parts, summed in fp32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _pi(c):
    """The key that V^T's position c of a group of 8 holds."""
    return (c % 4) * 2 + c // 4


def wide_3xtf32(q, k, v, scale, fixed):
    """(out, lse) as the wide kernel computes them over (B, H, S, D) fp32:
    q prescaled, per 32-key tile S = S_0 + S_1 with S_r the 3xTF32 product
    over head-dim columns [256 r, 256 r + 256); the fixed cap or a running
    max; P (split, its columns in V^T's permuted order) . V^T's rows; o / l
    at the end (lse None for the fixed cap)."""
    d = q.shape[-1]
    sk = k.shape[2]
    qp = q * (scale * LOG2E)
    o = torch.zeros(q.shape)
    m = torch.full(q.shape[:3] + (1,), -1e30)
    l = torch.zeros(q.shape[:3] + (1,))
    for j0 in range(0, sk, BK):
        kt, vt = k[:, :, j0:j0 + BK], v[:, :, j0:j0 + BK]
        s = [mm3(qp[..., r * DS:(r + 1) * DS],
                 kt[..., r * DS:(r + 1) * DS].transpose(-1, -2))
             for r in range(-(-d // DS))]
        s = s[0] + s[1] if len(s) == 2 else s[0]
        if fixed:
            p = torch.exp2(torch.clamp(s, max=60.0))
        else:
            mx = torch.maximum(m, s.amax(-1, keepdim=True))
            a = torch.exp2(m - mx)
            p = torch.exp2(s - mx)
            l, o, m = l * a, o * a, mx
        l = l + p.sum(-1, keepdim=True)
        n = kt.shape[2]
        perm = [8 * (c // 8) + _pi(c % 8) for c in range(-(-n // 8) * 8)]
        pp = torch.nn.functional.pad(p, (0, len(perm) - n))[..., perm]
        vp = torch.nn.functional.pad(vt, (0, 0, 0, len(perm) - n))[:, :,
                                                                   perm]
        o = o + mm3(pp, vp)
    if fixed:
        return o / torch.clamp(l, min=1e-37), None
    return o / l, (m * LN2 + torch.log(l))[..., 0]


# (b, h, sq, sk, d): the VAE's head cut to 128 queries, a ragged pair at the
# narrowest head the kernel takes (CTA 1 holds 8 columns)
CASES = [(1, 1, 128, 128, 512), (1, 2, 40, 72, 264)]


def _inputs(case, seed):
    b, h, sq, sk, d = case
    return (_rand(seed, b, h, sq, d), _rand(seed + 1, b, h, sk, d),
            _rand(seed + 2, b, h, sk, d))


def _close(got, want):
    return np.abs(got - want).max() <= REL_TOL * np.abs(want).max() + ABS_TOL


@pytest.mark.parametrize("case", CASES)
def test_fixed_cap_emulation_matches_jax(case):
    q, k, v = _inputs(case, 50)
    jout = np.asarray(jflash.flash_attention_fixed(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    out, _ = wide_3xtf32(_t(q), _t(k), _t(v), case[-1] ** -0.5, True)
    assert _close(out.numpy(), jout)


@pytest.mark.parametrize("case", CASES)
def test_fwd_emulation_matches_jax(case):
    q, k, v = _inputs(case, 60)
    scale = case[-1] ** -0.5
    jout, jlse = jflash._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), scale)
    out, lse = wide_3xtf32(_t(q), _t(k), _t(v), scale, False)
    assert _close(out.numpy(), np.asarray(jout))
    assert np.abs(lse.numpy() - np.asarray(jlse)).max() <= LSE_ATOL


def test_emulation_matches_the_plain_versions():
    """The plain fp32 versions the card holds the kernel to agree with the
    emulation as closely."""
    q, k, v = (_t(a) for a in _inputs((1, 1, 64, 96, 512), 70))
    scale = 512 ** -0.5
    out, _ = wide_3xtf32(q, k, v, scale, True)
    assert _close(out.numpy(),
                  tflash.fixed_cap_attention_ref(q, k, v, scale).numpy())
    out, lse = wide_3xtf32(q, k, v, scale, False)
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, scale)
    assert _close(out.numpy(), ref.numpy())
    assert (lse - ref_lse).abs().max() <= LSE_ATOL


def test_score_halves_sum_to_the_same_bits_in_either_cta():
    """Each CTA adds its partial and the peer's: S_0 + S_1 and S_1 + S_0
    are the same fp32 bits, so both CTAs take the same softmax."""
    a, b = _t(_rand(1, 4096)), _t(_rand(2, 4096))
    assert torch.equal(a + b, b + a)


# ---------------------------------------------------------------------------
# the route and the pieces the kernel streams

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,want", [
    (F32, 264, "flash_{}_tf32"), (F32, 320, "flash_{}_tf32"),
    (F32, 512, "flash_{}_tf32"), (F32, 520, "flash_{}_simt"),
    (F32, 300, "flash_{}_simt"), (BF, 512, "flash_{}"),
    (BF, 300, "flash_{}_simt")])
def test_route_takes_the_wide_heads_to_the_tf32_kernel(dtype, d, want):
    for fixed in (True, False):
        assert tflash.route(dtype, d, fixed=fixed) \
            == want.format("fixed" if fixed else "fwd")


def _pieces(d):
    """The kernel's pieces a key tile for each CTA: (head-dim columns of
    the CTA, K pieces, the column blocks each K piece loads).  Every piece
    runs its 16 k8 steps: blocks it does not load meet Q's zeros."""
    out = []
    for rank in (0, 1):
        dv = min(d - rank * DS, DS)
        hv = -(-dv // 128)
        out.append((dv, hv,
                    [-(-min(dv - 128 * p, 128) // 32) for p in range(hv)]))
    return out


@pytest.mark.parametrize("d,want", [
    (512, [(256, 2, [4, 4]), (256, 2, [4, 4])]),
    (264, [(256, 2, [4, 4]), (8, 1, [1])]),
    (392, [(256, 2, [4, 4]), (136, 2, [4, 1])])])
def test_pieces_cover_the_head_dim_once(d, want):
    """CTA 1 loads only the column blocks below D (at D = 264 one K piece
    of one block); the blocks the two CTAs load hold every head-dim column
    once and no block wholly past D."""
    got = _pieces(d)
    assert got == want
    cols = [DS * r + 128 * p + 32 * c + i
            for r, (_, _, blocks) in enumerate(got)
            for p, n in enumerate(blocks) for c in range(n)
            for i in range(32)]
    assert sorted(x for x in cols if x < d) == list(range(d))
    assert max(cols) < -(-d // 32) * 32


def test_shared_memory_budget():
    """Q hi and lo of a CTA's 256 columns, two 32 KB slots, two exchange
    buffers of a 64 x 32 fp32 partial, the barriers and the alignment room
    fit the H100's 232,448 bytes; a third slot would not."""
    q, slot, x = 2 * 64 * DS * 4, 2 * BK * 128 * 4, 64 * BK * 4
    smem = q + 2 * slot + 2 * x + 8 * 7 + 1024
    assert smem == 214072 <= 232448 < smem + slot


# ---------------------------------------------------------------------------
# the wrapper (its launchers recorded)


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    for name in ("flash_tf32", "flash_tf32_wide"):
        monkeypatch.setattr(
            _kernels, name,
            lambda *a, fixed, name=name: calls.append((name, a, fixed)))
    return calls


@pytest.mark.parametrize("d,launcher", [(256, "flash_tf32"),
                                        (264, "flash_tf32_wide"),
                                        (512, "flash_tf32_wide")])
def test_wrapper_takes_the_wide_launcher_above_256(recorded, d, launcher):
    b, h, sq, sk = 1, 2, 50, 21
    q = torch.zeros(b, sq, h, d).transpose(1, 2)
    k = torch.zeros(b, h, sk, d)
    o = torch.empty(b, sq, h, d).transpose(1, 2)
    flash_tf32.fixed_cap(q, k, k, o, 0.25)
    lse = torch.empty(b, h, sq)
    flash_tf32.fwd(q, k, k, o, lse, 0.25)
    assert [(n, f) for n, _, f in recorded] == [(launcher, True),
                                               (launcher, False)]
    (qv, kv, vv, ov, lv, scratch, qscale) = recorded[1][1]
    assert qv is q and kv is k and ov is o and lv is lse
    assert scratch.dtype == torch.float32 \
        and scratch.numel() == 4 * b * h * 24 * d  # Sk rounded up to 8


def test_fp32_flash_tt_at_512_takes_the_wide_kernel(recorded, monkeypatch):
    """The transposed-layout forward in fp32 at the VAE's head goes to the
    natural-layout forward that ``route`` names: the wide 3xTF32 kernel."""
    monkeypatch.setattr(tflash, "_on_cpu", lambda t: False)
    q = torch.zeros(1, 1, 64, 512)
    out, lse = ttt.flash_fwd_tt(q, q, q, 512 ** -0.5)
    assert [(n, f) for n, _, f in recorded] == [("flash_tf32_wide", False)]
    assert out.shape == q.shape and lse.shape == (1, 1, 64)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 520),
                                     (torch.float32, 300),
                                     (torch.bfloat16, 512)])
def test_wrapper_refuses_what_the_kernel_does_not_take(recorded, dtype, d):
    q = torch.zeros(1, 1, 16, d, dtype=dtype)
    with pytest.raises(ValueError, match="flash_tf32"):
        flash_tf32.fixed_cap(q, q, q, torch.empty_like(q), 1.0)
    assert recorded == []

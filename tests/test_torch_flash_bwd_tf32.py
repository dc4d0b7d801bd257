"""The fp32 attention backward on 3xTF32 ``wgmma``
(``csrc/flash_bwd_tf32_sm90.cu``), held on the CPU: a numpy emulation of
the kernels' algorithm (the split pre-pass's folds, tf32 hi and lo parts
and permuted transposed operands, the dq and dk/dv kernels' tile walks
with three products a step) against the JAX package's Pallas backward
(interpret mode, as the JAX package's own tests run it) on the same numpy
inputs; the index algebra that carries ds0 and pᵀ from the accumulator
registers to the A registers; which kernels each backward call takes
(``flash_attention.route_bwd``); what the wrapper hands its launchers; and
the transposed-layout forward's fp32 route.  The kernels themselves meet
the plain versions on the card in ``tests/test_torch_kernels.py`` and
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.ops import flash_attention as jflash
from sdbc_tpu.ops import flash_attention_bwd as jbwd
from sdbc_tpu.ops import flash_attention_tt as jtt
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.ops import flash_attention as tflash
from sdbc_tpu_torch.ops import flash_attention_bwd as tbwd
from sdbc_tpu_torch.ops import flash_attention_tt as ttt
from sdbc_tpu_torch.ops import flash_bwd_tf32
from tests.torch_threads import one_thread  # noqa: F401

LOG2E = 1.4426950408889634
# The kernels' bound on the card (chip_smoke.SIMT_FP32_REL_TOL /
# SIMT_FP32_ABS_TOL): the split products lose ~2^-21 of each term and the
# sums run in other orders; 1e-4 of the largest entry plus 1e-6.
REL_TOL, ABS_TOL = 1e-4, 1e-6
# the transposed-layout forward against the JAX kernel, fp32 on both sides
# (test_torch_flash_tf32.py's bounds)
OUT_REL_TOL, LSE_ATOL = 1e-5, 1e-5


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want):
    return np.abs(got - want).max() <= REL_TOL * np.abs(want).max() + ABS_TOL


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated in numpy


def tf32(x):
    """x rounded to tf32 to nearest, ties away from zero (cvt.rna): half a
    tf32 ulp added to the magnitude bits, the low 13 bits cleared."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """a @ b as the kernels form it: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi,
    each product of tf32 values exact in fp32, summed in fp32."""
    ah, al = split(a)
    bh, bl = split(b)
    return ((al @ bh) + (ah @ bl)) + (ah @ bh)


def _pi(c):
    """The row that position c of a group of 8 of a transposed operand
    holds."""
    return (c % 4) * 2 + c // 4


def transposed(x, rows):
    """The pre-pass's transposed operand of (S, D) rows: (D, Sp), Sp = S
    rounded up to 8, position c holding row (c & ~7) | pi(c & 7) (zero past
    S), as split_bwd_kernel writes it."""
    s, d = x.shape
    sp = -(-s // 8) * 8
    src = [(c & ~7) | ((c & 3) * 2 + ((c >> 2) & 1)) for c in range(sp)]
    out = np.zeros((d, sp), np.float32)
    for c, r in enumerate(src):
        if r < s:
            out[:, c] = x[r]
    return out


def cfg(d, dkv):
    """(resident rows, streamed rows a step) of the instantiation a head
    dim runs (csrc/flash_bwd_tf32_sm90.cu's Cfg: NV = 40, 80 or 160)."""
    nv = 40 if d <= 40 else 80 if d <= 80 else 160
    br = 128 if nv == 40 else 64
    bt = (32 if dkv else 64) if nv == 40 else 32 if nv == 80 else 16
    return br, bt


def _permuted(x, t0, bt):
    """Columns [t0, t0 + bt) of an accumulator tile as the A fragments take
    them against a permuted transposed operand: position c holds column
    t0 + (c & ~7) + pi(c & 7)."""
    return x[:, [t0 + (c & ~7) + _pi(c & 7) for c in range(bt)]]


def bwd_3xtf32(q, k, v, do, lse2, delta, scale):
    """(dq, dk, dv) of one (b, h) as the kernels compute them from the
    unscaled q, k and ``prepare``'s lse2 and delta (zero-padded rows)."""
    sq, d = q.shape
    sk = k.shape[0]
    qs = q * np.float32(scale)  # the pre-pass's folds: one fp32 multiply
    kl = k * np.float32(LOG2E)
    klt = transposed(kl, sk)
    qst, dot = transposed(qs, sq), transposed(do, sq)

    def rows(x, r0, n):  # rows [r0, r0 + n) of x, zero past its end
        out = np.zeros((n, x.shape[1]), np.float32)
        out[:max(0, min(n, len(x) - r0))] = x[r0:r0 + n]
        return out

    def cols(x, c0, n):  # positions [c0, c0 + n), zero past the end
        return rows(x.T, c0, n).T

    dq = np.zeros((sq, d), np.float32)
    br, bt = cfg(d, False)
    for q0 in range(0, sq, br):
        qt, dt = rows(qs, q0, br), rows(do, q0, br)
        l2 = lse2[q0:q0 + br][:, None]
        dl = delta[q0:q0 + br][:, None]
        acc = np.zeros((br, d), np.float32)
        for j0 in range(0, sk, bt):
            s = mm3(qt, rows(kl, j0, bt).T)
            s[:, max(0, sk - j0):] = -1e30  # keys past Sk
            p = np.exp2(s - l2)
            ds = p * (mm3(dt, rows(v, j0, bt).T) - dl)
            acc += mm3(_permuted(ds, 0, bt), cols(klt, j0, bt).T)
        dq[q0:q0 + br] = (acc * np.float32(scale / LOG2E))[:sq - q0]

    dk = np.zeros((sk, d), np.float32)
    dv = np.zeros((sk, d), np.float32)
    br, bt = cfg(d, True)
    for k0 in range(0, sk, br):
        kt, vt = rows(kl, k0, br), rows(v, k0, br)
        ak = np.zeros((br, d), np.float32)
        av = np.zeros((br, d), np.float32)
        for i0 in range(0, sq, bt):
            l2, dl = lse2[i0:i0 + bt][None], delta[i0:i0 + bt][None]
            pt = np.exp2(mm3(kt, rows(qs, i0, bt).T) - l2)
            dst = pt * (mm3(vt, rows(do, i0, bt).T) - dl)
            av += mm3(_permuted(pt, 0, bt), cols(dot, i0, bt).T)
            ak += mm3(_permuted(dst, 0, bt), cols(qst, i0, bt).T)
        dk[k0:k0 + br] = ak[:sk - k0]
        dv[k0:k0 + br] = av[:sk - k0]
    return dq, dk, dv


# (b, h, sq, sk, d): the 64² level's head dim at a shorter sequence, the
# 32² and 16² levels' head dims, the ragged pair
CASES = [(1, 2, 256, 256, 40), (1, 1, 128, 160, 80), (1, 1, 64, 96, 160),
         (2, 2, 200, 300, 40)]


def _inputs(case, seed):
    b, h, sq, sk, d = case
    return (_rand(seed, b, h, sq, d), _rand(seed + 1, b, h, sk, d),
            _rand(seed + 2, b, h, sk, d), _rand(seed + 3, b, h, sq, d))


@pytest.mark.parametrize("case", CASES)
def test_bwd_emulation_matches_jax(case):
    q, k, v, do = _inputs(case, 40)
    scale = case[-1] ** -0.5
    o, lse = jflash._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), scale)
    want = [np.asarray(t) for t in jbwd.flash_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, jnp.asarray(do),
        lse, scale)]
    lse2, delta = tbwd.prepare_vectors(torch.from_numpy(np.array(o)),
                                       torch.from_numpy(do),
                                       torch.from_numpy(np.array(lse)))
    lse2, delta = lse2.numpy(), delta.numpy()
    got = [np.zeros_like(w) for w in want]
    for b in range(case[0]):
        for h in range(case[1]):
            for g, part in zip(got, bwd_3xtf32(q[b, h], k[b, h], v[b, h],
                                               do[b, h], lse2[b, h],
                                               delta[b, h], scale)):
                g[b, h] = part
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _close(g, w), name


def test_emulation_matches_the_plain_version():
    """``flash_bwd_prepared_ref`` on ``prepare``'s inputs, the plain
    version the card holds the kernels to, agrees with the emulation as
    closely as with the JAX kernels."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs((1, 1, 200, 300,
                                                         80), 50))
    scale = 80 ** -0.5
    o, lse = tflash.flash_attention_ref(q, k, v, scale)
    qs, kl, lse2, delta = tbwd.prepare(q, k, o, do, lse, scale)
    ref = tbwd.flash_bwd_prepared_ref(qs, kl, v, do, lse2, delta, scale)
    got = bwd_3xtf32(q[0, 0].numpy(), k[0, 0].numpy(), v[0, 0].numpy(),
                     do[0, 0].numpy(), lse2[0, 0].numpy(),
                     delta[0, 0].numpy(), scale)
    for g, r in zip(got, ref):
        assert _close(g, r[0, 0].numpy())


def test_prepass_folds_as_prepare_does():
    """The pre-pass's folds (one fp32 multiply by scale and by log2e, as
    float32 constants) give ``prepare``'s qs and kl bit for bit."""
    x = _rand(60, 1, 2, 64, 40)
    for mult in (40 ** -0.5, 80 ** -0.5, 160 ** -0.5, LOG2E):
        assert np.array_equal(x * np.float32(mult),
                              tbwd._fold(torch.from_numpy(x), mult).numpy())


# ---------------------------------------------------------------------------
# ds0 and pᵀ from the accumulator registers to the A registers


def _fragments(acc):
    """One warp's A fragments of a k8 step from its accumulator chunk
    (16 rows x 8 columns): lane (g, t) holds acc[g, 2t], acc[g, 2t+1],
    acc[g+8, 2t], acc[g+8, 2t+1] and passes them as a0, a2, a1, a3
    (gemm_tr's order), which the tf32 A fragment reads as (g, t),
    (g, t+4), (g+8, t), (g+8, t+4)."""
    a = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        s = [acc[g, 2 * t], acc[g, 2 * t + 1], acc[g + 8, 2 * t],
             acc[g + 8, 2 * t + 1]]
        a0, a1, a2, a3 = s[0], s[2], s[1], s[3]
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a0, a1, a2, a3
    return a


def test_permuted_klt_carries_ds0_from_the_accumulator_to_the_a_fragment():
    """The dq kernel: ds0 (q rows x keys) from the S/dP accumulator times
    klᵀ's rows permuted by pi is ds0·kl."""
    rng = np.random.default_rng(1)
    ds = rng.standard_normal((16, 8))
    kl = rng.standard_normal((8, 40))
    klt = transposed(kl.astype(np.float32), 8).astype(np.float64)
    np.testing.assert_allclose(_fragments(ds) @ klt.T, ds @ kl.astype(
        np.float32), rtol=0, atol=1e-5)


def test_permuted_dot_carries_pt_from_the_st_accumulator_to_the_a_fragment():
    """The dk/dv kernel: Sᵀ's accumulator indexes the key rows by row and
    the q rows by column, so pᵀ (and ds0ᵀ) go to the A fragments the same
    way, against dOᵀ (and qsᵀ) permuted by pi: pᵀ·dO."""
    rng = np.random.default_rng(2)
    pt = rng.standard_normal((16, 8))  # 16 key rows x 8 q rows
    do = rng.standard_normal((8, 80)).astype(np.float32)
    dot = transposed(do, 8).astype(np.float64)
    np.testing.assert_allclose(_fragments(pt) @ dot.T, pt @ do, rtol=0,
                               atol=1e-5)


def test_transposed_tiles_stay_within_their_groups():
    """The pre-pass's source row of position c is a permutation of each
    group of 8, and positions past S of a ragged group hold its rows past S
    as zeros: a streamed tile of 16, 32 or 64 positions holds whole
    groups."""
    x = np.arange(1, 13, dtype=np.float32)[:, None]  # 12 rows
    t = transposed(x, 12)[0]
    assert t.shape == (16,)
    assert sorted(t[:8].tolist()) == list(range(1, 9))
    assert sorted(t[8:].tolist()) == [0.0] * 4 + list(range(9, 13))


def test_scratch_size_matches_the_kernels_layout():
    """``scratch_floats`` is csrc/flash_bwd_tf32_sm90.cu's scratch_of:
    four (S, D) parts a side, four (D, Sqp) q-side and two (D, Skp)
    key-side transposed parts."""
    b, h, sq, sk, d = 2, 3, 200, 77, 40
    assert flash_bwd_tf32.scratch_floats(b, h, sq, sk, d) == (
        4 * b * h * sq * d + 4 * b * h * sk * d + 4 * b * h * d * 200
        + 2 * b * h * d * 80)


# ---------------------------------------------------------------------------
# the route: dtype × head dim → the backward's kernels

BF, F32 = torch.bfloat16, torch.float32
BF_K = ("flash_bwd_dq", "flash_bwd_dkv")
TF_K = ("flash_bwd_dq_tf32", "flash_bwd_dkv_tf32")
SIMT_K = ("flash_bwd_simt_dq", "flash_bwd_simt_dkv")
ROUTES = [(BF, 8, BF_K), (BF, 40, BF_K), (BF, 44, SIMT_K), (BF, 160, BF_K),
          (BF, 512, BF_K), (BF, 520, SIMT_K), (F32, 8, TF_K), (F32, 40, TF_K),
          (F32, 44, SIMT_K), (F32, 64, TF_K), (F32, 80, TF_K),
          (F32, 160, TF_K), (F32, 168, SIMT_K), (F32, 256, SIMT_K),
          (F32, 512, SIMT_K), (torch.float16, 40, SIMT_K), (None, 40, SIMT_K)]


@pytest.mark.parametrize("dtype,d,want", ROUTES)
def test_route_bwd_by_dtype_and_head_dim(dtype, d, want):
    assert tflash.route_bwd(dtype, d) == want


def test_route_bwd_covers_every_head_dim_of_sd_training():
    """SD-1.x's attention head dims (40, 80, 160) take the 3xTF32 backward
    in fp32, as they take the 3xTF32 forward."""
    for d in (40, 80, 160):
        assert tflash.route_bwd(F32, d) == TF_K
        assert tflash.route(F32, d, fixed=False) == "flash_fwd_tf32"


# ---------------------------------------------------------------------------
# the wrapper (its launchers recorded)


@pytest.fixture
def recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(_kernels, "flash_bwd_dq_tf32",
                        lambda *a: calls.append(("dq", a)))
    monkeypatch.setattr(_kernels, "flash_bwd_dkv_tf32",
                        lambda *a: calls.append(("dkv", a)))
    return calls


def _vectors(b, h, sq):
    pad = -(-sq // 128) * 128
    return torch.zeros(b, h, pad), torch.zeros(b, h, pad)


def test_wrapper_hands_the_views_scratch_and_scales(recorded):
    b, h, sq, sk, d = 2, 3, 50, 21, 40
    q = torch.zeros(b, sq, h, d).transpose(1, 2)  # projection layout
    k = torch.zeros(b, h, sk, d)
    do = torch.zeros(b, h, sq, d)
    lse2, delta = _vectors(b, h, sq)
    dq, dk, dv = flash_bwd_tf32.bwd(q, k, k, do, lse2, delta, 0.25)
    (n1, (qv, kv, vv, dov, l2, dl, dqv, scratch, scale, dq_mul)), \
        (n2, (q2, k2, l22, dl2, dkv_, dvv, scratch2)) = recorded
    assert (n1, n2) == ("dq", "dkv")
    assert qv is q and kv is k and vv is k and dov is do and q2 is q
    assert l2 is lse2 and dl is delta and l22 is lse2 and dl2 is delta
    assert dqv is dq and dkv_ is dk and dvv is dv and scratch2 is scratch
    assert scratch.dtype == torch.float32 and scratch.numel() \
        == flash_bwd_tf32.scratch_floats(b, h, sq, sk, d)
    assert scale == 0.25 and dq_mul == pytest.approx(0.25 / LOG2E)
    # the gradients in the projection layout, as the bf16 kernels give them
    assert dq.shape == q.shape and dq.stride() == (sq * h * d, d, h * d, 1)
    assert dk.shape == k.shape and dk.stride() == (sk * h * d, d, h * d, 1)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 40),
                                     (torch.float32, 44),
                                     (torch.float32, 168)])
def test_wrapper_refuses_what_the_kernels_do_not_take(recorded, dtype, d):
    q = torch.zeros(1, 1, 16, d, dtype=dtype)
    with pytest.raises(ValueError, match="flash_bwd_tf32"):
        flash_bwd_tf32.bwd(q, q, q, q, *_vectors(1, 1, 16), 1.0)
    assert recorded == []


def test_wrapper_refuses_a_wrong_do_or_vector(recorded):
    q = torch.zeros(1, 2, 16, 40)
    good = _vectors(1, 2, 16)
    for do in (q.double(), torch.zeros(1, 2, 15, 40)):
        with pytest.raises(ValueError, match="do"):
            flash_bwd_tf32.bwd(q, q, q, do, *good, 1.0)
    for bad in (torch.zeros(1, 2, 16), torch.zeros(1, 2, 128).double(),
                torch.zeros(1, 3, 128), torch.zeros(2, 1, 128, 2)[..., 0]):
        with pytest.raises(ValueError, match="lse2"):
            flash_bwd_tf32.bwd(q, q, q, q, bad, good[1], 1.0)
    assert recorded == []


def test_flash_bwd_sends_fp32_to_the_tf32_kernels(recorded, monkeypatch):
    """``flash_bwd`` on fp32 CUDA tensors (the device check stubbed) hands
    the unscaled q and k and ``prepare_vectors``' lse2 and delta to the
    3xTF32 kernels: no torch fold."""
    monkeypatch.setattr(tflash, "_on_cpu", lambda t: False)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs((1, 2, 64, 64, 40),
                                                        70))
    o, lse = tflash.flash_attention_ref(q, k, v, 0.1)
    tbwd.flash_bwd(q, k, v, o, do, lse, 0.1)
    (_, (qv, kv, _, dov, lse2, delta, *_)), _ = recorded
    assert qv is q and kv is k and dov is do
    want = tbwd.prepare_vectors(o, do, lse)
    assert torch.equal(lse2, want[0]) and torch.equal(delta, want[1])
    assert lse2.shape == (1, 2, 128)


# ---------------------------------------------------------------------------
# the transposed-layout forward in fp32 (K9′)


@pytest.mark.parametrize("case", [(1, 2, 256, 256, 40), (1, 2, 200, 300, 80)])
def test_flash_fwd_tt_fp32_matches_jax(case):
    """The transposed-layout forward on the CPU (the plain version its
    fp32 kernel is held to) against the JAX package's ``_flash_fwd_tt`` in
    fp32 on the same inputs."""
    q, k, v, _ = _inputs(case, 80)
    scale = case[-1] ** -0.5
    jout, jlse = jtt._flash_fwd_tt(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), scale)
    out, lse = ttt.flash_fwd_tt(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), scale)
    jout = np.asarray(jout)
    assert np.abs(out.numpy() - jout).max() \
        <= OUT_REL_TOL * np.abs(jout).max()
    assert np.abs(lse.numpy() - np.asarray(jlse)).max() <= LSE_ATOL

"""The cases the wgmma flash backward (``csrc/flash_bwd_sm90.cu``) can get
wrong, held on the CPU: the plain backward against the JAX package's
Pallas kernels (interpret mode, as the JAX package's own tests run them) on
the same numpy inputs at a ragged key count with late row maxima; the
wrapper's prepared inputs (the folds and the zero-padded lse2/delta) fed
through the plain version of what the kernels compute, also against the
JAX kernels at the head dims of ``csrc/flash_bwd_wide_sm90.cu``; and the
wrapper's routing to the kernel entry points by head dim.  The kernels
themselves meet the same cases on the card in ``tests/test_torch_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.ops import flash_attention_bwd as jbwd
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.ops import flash_attention as tflash
from sdbc_tpu_torch.ops import flash_attention_bwd as tbwd
from tests.torch_threads import one_thread  # noqa: F401

SQ, SK = 200, 300  # neither a multiple of the kernels' 32-, 64- or 128-row tiles
GRAD_ATOL = 2e-4  # fp32 on both sides: tests/test_torch_train_ops.py's bound


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _late_max(d, seed=10):
    """Head-major q, k, v, dO whose row maxima lie only in the last keys
    (280..299, past every tile boundary)."""
    u = _rand(seed, d)
    u /= np.linalg.norm(u)
    q = _rand(seed + 1, 1, 2, SQ, d, scale=0.5) + 5.0 * u
    k = _rand(seed + 2, 1, 2, SK, d, scale=0.5)
    k[:, :, 280:] += 6.0 * u
    return q, k, _rand(seed + 3, 1, 2, SK, d), _rand(seed + 4, 1, 2, SQ, d)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("d", [40, 80, 160])
def test_flash_bwd_ref_matches_jax_with_a_late_max(d):
    q, k, v, do = _late_max(d)
    assert (np.einsum("bhqd,bhkd->bhqk", q, k).argmax(-1) >= 280).all()
    scale = d ** -0.5
    o, lse = tflash.flash_attention_ref(_t(q), _t(k), _t(v), scale)
    jg = jbwd.flash_bwd(*(jnp.asarray(a) for a in (q, k, v, o.numpy(), do,
                                                   lse.numpy())), scale)
    tg = tbwd.flash_bwd_ref(_t(q), _t(k), _t(v), o, _t(do), lse, scale)
    for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fold_rounds_once(dtype):
    """``_fold``'s one multiply gives the values of the explicit fp32 round
    trip, bit for bit, over values spread across the exponent range."""
    x = _rand(30, 1 << 20) * np.exp(_rand(31, 1 << 20) * 3)
    x = torch.from_numpy(x).to(dtype)
    for mult in (40 ** -0.5, 80 ** -0.5, 160 ** -0.5, tbwd.LOG2E, 0.1):
        assert torch.equal(tbwd._fold(x, mult),
                           (x.float() * mult).to(dtype)), mult


@pytest.mark.parametrize("dtype,atol", [
    # fp32: the pad rows add exact zeros, so only the products' summation
    # order differs (~1e-7 of outputs up to ~4)
    (torch.float32, 1e-5),
    # bf16: the same rounding points (qs, kl, ds0, p) and fp32 sums; a sum
    # in another order may round a gradient one bf16 ulp the other way,
    # 2^-6 at the outputs' size (|x| < 4)
    (torch.bfloat16, 2.0 ** -6)])
def test_prepared_inputs_give_the_plain_gradients(dtype, atol):
    """The wrapper's prepared inputs (qs, kl folded once; lse2 and delta
    zero-padded to whole 128-row q tiles), through the plain version of
    what the kernels compute, give ``flash_bwd_ref``'s gradients."""
    d = 40
    q, k, v, do = (_t(a).to(dtype) for a in _late_max(d))
    scale = d ** -0.5
    o, lse = tflash.flash_attention_ref(q, k, v, scale)
    qs, kl, lse2, delta = tbwd.prepare(q, k, o, do, lse, scale)
    assert qs.dtype == kl.dtype == dtype
    assert lse2.shape == delta.shape == (1, 2, 256)
    assert lse2.dtype == delta.dtype == torch.float32
    assert lse2.is_contiguous() and delta.is_contiguous()
    assert not lse2[..., SQ:].any() and not delta[..., SQ:].any()
    torch.testing.assert_close(lse2[..., :SQ], lse * tbwd.LOG2E, rtol=0,
                               atol=0)
    torch.testing.assert_close(delta[..., :SQ],
                               (do.float() * o.float()).sum(-1), rtol=0,
                               atol=0)
    assert torch.equal(qs, (q.float() * scale).to(dtype))
    assert torch.equal(kl, (k.float() * tbwd.LOG2E).to(dtype))
    got = tbwd.flash_bwd_prepared_ref(qs, kl, v, do, lse2, delta, scale)
    want = tbwd.flash_bwd_ref(q, k, v, o, do, lse, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == dtype, name
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=atol,
                                   msg=name)


@pytest.mark.parametrize("d,route", [(8, "sm90"), (40, "sm90"), (80, "sm90"),
                                     (160, "sm90"), (192, "sm90"),
                                     (200, "wide"), (256, "wide"),
                                     (320, "wide"), (512, "wide")])
def test_flash_bwd_routes_by_head_dim(monkeypatch, d, route):
    """Head dims up to 192 go to the kernels of ``csrc/flash_bwd_sm90.cu``,
    wider ones (up to 512, as the JAX backward pads any head dim) to those
    of ``csrc/flash_bwd_wide_sm90.cu``; both take the folded operands and
    the padded lse2/delta, and each launches dq once and dk/dv once into
    (B, H, S, D) views over (B, S, H, D) memory."""
    calls = []

    def record(name):
        def launch(*args):
            calls.append((name, args))
        return launch

    monkeypatch.setattr(tflash, "_on_cpu", lambda t: False)
    for name in ("flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_wide",
                 "flash_bwd_dkv_wide"):
        monkeypatch.setattr(_kernels, name, record(name))
    rng = np.random.default_rng(d)
    bshd = lambda s: torch.from_numpy(rng.standard_normal(
        (1, s, 2, d)).astype(np.float32)).bfloat16().transpose(1, 2)
    q, k, v, o, do = bshd(64), bshd(77), bshd(77), bshd(64), bshd(64)
    lse = torch.zeros(1, 2, 64)
    scale = d ** -0.5
    dq, dk, dv = tbwd.flash_bwd(q, k, v, o, do, lse, scale)
    suffix = "" if route == "sm90" else "_wide"
    assert [c[0] for c in calls] == ["flash_bwd_dq" + suffix,
                                     "flash_bwd_dkv" + suffix]
    (_, dq_args), (_, dkv_args) = calls
    assert dq_args[6] is dq and dkv_args[6] is dk and dkv_args[7] is dv
    for g, ref in ((dq, q), (dk, k), (dv, v)):
        assert g.shape == ref.shape and g.stride()[1] == d  # heads inner
    qs, kl, _, _, lse2, delta = dq_args[:6]
    torch.testing.assert_close(qs, tbwd._fold(q, scale), rtol=0, atol=0)
    torch.testing.assert_close(kl, tbwd._fold(k, tbwd.LOG2E), rtol=0, atol=0)
    assert qs.stride() == q.stride() and kl.stride() == k.stride()
    assert lse2.shape == delta.shape == (1, 2, tbwd.Q_TILE)
    assert dq_args[7] == pytest.approx(scale / tbwd.LOG2E)
    assert all(a is b for a, b in zip(dkv_args[:6], dq_args[:6]))


@pytest.mark.parametrize("d", [200, 320, 512])
def test_prepared_ref_matches_jax_at_wide_heads(d):
    """What the wide kernels compute (``flash_bwd_prepared_ref`` on
    ``prepare``'s folded operands and zero-padded lse2/delta) against the
    JAX ``flash_bwd`` (interpret mode) at head dims that split unevenly
    over the kernels' two CTAs, on a ragged Sq/Sk, fp32 on both sides."""
    sq, sk = 70, 45
    q, k, v, do = (_rand(s, 1, 2, n, d) for s, n in ((70 + d, sq),
                                                      (71 + d, sk),
                                                      (72 + d, sk),
                                                      (73 + d, sq)))
    scale = d ** -0.5
    o, lse = tflash.flash_attention_ref(_t(q), _t(k), _t(v), scale)
    qs, kl, lse2, delta = tbwd.prepare(_t(q), _t(k), o, _t(do), lse, scale)
    assert lse2.shape == (1, 2, tbwd.Q_TILE)
    got = tbwd.flash_bwd_prepared_ref(qs, kl, _t(v), _t(do), lse2, delta,
                                      scale)
    jg = jbwd.flash_bwd(*(jnp.asarray(a) for a in (q, k, v, o.numpy(), do,
                                                   lse.numpy())), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, jg):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=name)


def test_flash_bwd_refuses_head_dims_above_512(monkeypatch):
    monkeypatch.setattr(tflash, "_on_cpu", lambda t: False)
    q = torch.zeros(1, 2, 64, 520, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="≤ 512"):
        tbwd.flash_bwd(q, q, q, q, q, torch.zeros(1, 2, 64), 520 ** -0.5)


def test_flash_attention_grad_at_head_dim_512_matches_jax():
    """The VAE's 512-wide head: the port's ``flash_attention`` gradient
    (autograd through ``_FlashAttention``, the plain backward on the CPU)
    against the JAX ``flash_bwd`` (interpret mode, head dim padded as its
    wrapper pads it) on a short ragged sequence, fp32 on both sides within
    the bound of the other head dims (``GRAD_ATOL``)."""
    d, sq, sk = 512, 40, 70
    q, k, v, do = (_rand(s, 1, 1, n, d) for s, n in ((60, sq), (61, sk),
                                                      (62, sk), (63, sq)))
    scale = d ** -0.5
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, scale=scale)
    out.backward(_t(do))
    o, lse = tflash.flash_attention_ref(_t(q), _t(k), _t(v), scale)
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    jg = jbwd.flash_bwd(*(jnp.asarray(a) for a in (q, k, v, o.numpy(), do,
                                                   lse.numpy())), scale)
    for name, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          jg):
        assert a.shape == (1, 1, sq if name == "dq" else sk, d)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   err_msg=name)

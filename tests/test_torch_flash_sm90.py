"""The cases the wgmma flash forwards (``csrc/flash_fwd_sm90.cu``, and
``csrc/flash_fwd_wide_sm90.cu`` above head dim 256) can get wrong, held on
the CPU: the plain versions of the fixed-cap attention and the training
forward against the JAX package's Pallas kernels (interpret mode, as the
JAX package's own tests run them) on the same numpy inputs at a ragged key
count and at the wide heads, and the wrappers' routing to the kernel entry
points.
The kernel itself meets the same cases on the card in
``tests/test_torch_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.ops import flash_attention as jflash
from sdbc_tpu.ops import flash_attention_tt as jtt
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.ops import flash_attention as tflash
from tests.torch_threads import one_thread  # noqa: F401

SK = 300  # not a multiple of the kernel's 64- or 128-key tiles
# fp32 on both sides, summation order only.  Near the cap the logits reach
# ~58 in log2 units, where one fp32 ulp of s (~4e-6) moves p by ~3e-6 of
# itself: the outputs (|o| ≤ ~3) are held to 1e-4.
NEAR_CAP_ATOL = 1e-4
OUT_ATOL, LSE_ATOL = 2e-5, 1e-5  # test_torch_train_ops.py's K5 bounds


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _near_cap(b=1, h=2, sq=200, sk=SK, d=40, seed=0):
    """Head-major q, k, v whose natural logits reach ~40 (the fixed cap is
    60/log2e ≈ 41.6): q and the keys 250.. share a direction u with
    scale·c² ≈ 36."""
    u = _rand(seed, d)
    u /= np.linalg.norm(u)
    c = np.sqrt(36.0 * np.sqrt(d))
    q = _rand(seed + 1, b, h, sq, d, scale=0.2) + c * u
    k = _rand(seed + 2, b, h, sk, d, scale=0.2)
    k[:, :, 250:] += c * u
    return q, k, _rand(seed + 3, b, h, sk, d)


def _late_max(b=1, h=2, sq=200, sk=SK, d=40, seed=10):
    """Head-major q, k, v whose row maxima lie only in the last keys
    (280..299, past every 64- and 128-key tile boundary): the running max
    has to rescale the sums of all earlier tiles."""
    u = _rand(seed, d)
    u /= np.linalg.norm(u)
    q = _rand(seed + 1, b, h, sq, d, scale=0.5) + 5.0 * u
    k = _rand(seed + 2, b, h, sk, d, scale=0.5)
    k[:, :, 280:] += 6.0 * u
    return q, k, _rand(seed + 3, b, h, sk, d)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_near_cap_inputs_reach_the_cap():
    q, k, _ = _near_cap()
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * q.shape[-1] ** -0.5
    assert 35.0 < s.max() < 60.0 / np.log2(np.e)


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_fixed_cap_plain_matches_jax_near_the_cap(layout):
    q, k, v = _near_cap()
    if layout == "bhsd":
        jout = jflash.flash_attention_fixed(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
        out = tflash.flash_attention_fixed(_t(q), _t(k), _t(v))
    else:
        tr = lambda a: np.swapaxes(a, 1, 2)
        jout = np.swapaxes(np.asarray(jflash.flash_attention_fixed_bshd(
            *(jnp.asarray(tr(a)) for a in (q, k, v)))), 1, 2)
        out = tflash.flash_attention_fixed_bshd(
            *(_t(tr(a)) for a in (q, k, v))).transpose(1, 2)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=NEAR_CAP_ATOL)


def test_training_forward_plain_matches_jax_with_a_late_max():
    q, k, v = _late_max()
    scale = q.shape[-1] ** -0.5
    s = np.einsum("bhqd,bhkd->bhqk", q, k)
    assert (s.argmax(-1) >= 280).all()  # every row's maximum is late
    # 128-key blocks: the JAX kernel rescales across its KV loop too
    jout, jlse = jflash._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), scale, block_q=128,
                                   block_kv=128)
    out, lse = tflash.flash_attention_ref(_t(q), _t(k), _t(v), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=LSE_ATOL)


@pytest.mark.parametrize("layout", ["natural", "tt"])
@pytest.mark.parametrize("d", [320, 512])
def test_training_forward_plain_matches_jax_at_wide_heads(layout, d):
    """The head dims of the wide kernel (``csrc/flash_fwd_wide_sm90.cu``,
    above 256): the plain forward against the JAX package's ``_flash_fwd``
    and ``_flash_fwd_tt`` (interpret mode, 128-row blocks), 40 q rows over
    70 keys, two heads."""
    q, k, v = (_rand(seed, 1, 2, n, d)
               for seed, n in ((20, 40), (21, 70), (22, 70)))
    scale = d ** -0.5
    fwd = jflash._flash_fwd if layout == "natural" else jtt._flash_fwd_tt
    jout, jlse = fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                     block_q=128, block_kv=128)
    out, lse = tflash.flash_attention_ref(_t(q), _t(k), _t(v), scale)
    assert out.shape == (1, 2, 40, d) and lse.shape == (1, 2, 40)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=LSE_ATOL)


@pytest.mark.parametrize("d,entry", [(8, "flash_fwd"), (40, "flash_fwd"),
                                     (160, "flash_fwd"), (256, "flash_fwd"),
                                     (512, "flash_fwd_wide")])
def test_flash_fwd_routes_by_head_dim(monkeypatch, d, entry):
    """Head dims up to 256 go to ``csrc/flash_fwd_sm90.cu``'s kernel, wider
    ones to ``csrc/flash_fwd_wide_sm90.cu``'s; both get the (B, H, S, D)
    views and an fp32 LSE."""
    calls = []

    def record(name):
        def launch(q, k, v, o, lse, qscale):
            calls.append((name, q.shape, o.shape, lse.shape, lse.dtype,
                          qscale))
        return launch

    monkeypatch.setattr(tflash, "_on_cpu", lambda t: False)
    for name in ("flash_fwd", "flash_fwd_wide"):
        monkeypatch.setattr(_kernels, name, record(name))
    q = torch.zeros(1, 64, 2, d, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(1, 77, 2, d, dtype=torch.bfloat16).transpose(1, 2)
    tflash.flash_fwd(q, k, k, d ** -0.5)
    assert len(calls) == 1
    name, qs, os_, ls, ldt, qscale = calls[0]
    assert name == entry
    assert qs == os_ == (1, 2, 64, d) and ls == (1, 2, 64)
    assert ldt == torch.float32
    assert qscale == pytest.approx(d ** -0.5 * tflash.LOG2E)


@pytest.mark.parametrize("d,entry", [(8, "flash_fwd_tt"), (40, "flash_fwd_tt"),
                                     (160, "flash_fwd_tt"),
                                     (256, "flash_fwd_tt"),
                                     (320, "flash_fwd_tt_wide"),
                                     (512, "flash_fwd_tt_wide")])
def test_flash_fwd_tt_routes_by_head_dim(monkeypatch, d, entry):
    """The transposed-layout forward: head dims up to 256 go to the
    head-dim-major variant of ``csrc/flash_fwd_sm90.cu``'s kernel, wider
    ones to that of ``csrc/flash_fwd_wide_sm90.cu``'s.  Both get ``to_tt``'s (B, H, D, S8) copies and the output as the first
    Sq columns of a (B, H, D, Sq8) buffer (TMA's 16-byte row stride; Sq =
    140 is no multiple of 8)."""
    from sdbc_tpu_torch.ops import flash_attention_tt as ttt

    calls = []

    def record(name):
        def launch(q, k, v, o, lse, sk, qscale):
            calls.append((name, q, k, v, o, lse, sk, qscale))
        return launch

    monkeypatch.setattr(tflash, "_on_cpu", lambda t: False)
    for name in ("flash_fwd_tt", "flash_fwd_tt_wide"):
        monkeypatch.setattr(_kernels, name, record(name))
    q = torch.randn(1, 140, 2, d).bfloat16().transpose(1, 2)
    k = torch.randn(1, 77, 2, d).bfloat16().transpose(1, 2)
    out, lse = ttt.flash_fwd_tt(q, k, k, d ** -0.5)
    assert len(calls) == 1
    name, qt, kt, vt, o, ls, sk, qscale = calls[0]
    assert name == entry
    assert qt.shape == (1, 2, d, 144) and kt.shape == vt.shape == (1, 2, d, 80)
    assert all(t.is_contiguous() for t in (qt, kt, vt))
    assert torch.equal(qt[..., :140], q.transpose(-1, -2))
    assert not qt[..., 140:].any() and not kt[..., 77:].any()
    assert o.shape == (1, 2, d, 140) and o.stride() == (2 * d * 144, d * 144,
                                                          144, 1)
    assert o.data_ptr() % 16 == 0
    assert ls.shape == (1, 2, 140) and ls.dtype == torch.float32
    assert sk == 77 and qscale == pytest.approx(d ** -0.5 * tflash.LOG2E)
    assert out.shape == (1, 2, 140, d) and out.data_ptr() == o.data_ptr()
    assert lse is ls


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_fixed_cap_hands_the_kernel_projection_layout_views(monkeypatch,
                                                            layout):
    """Both fixed-cap entry points launch one kernel over (B, S, H, D)
    logical views: the head-major layout arrives as transposed views of
    the caller's tensors, not as copies."""
    calls = []
    monkeypatch.setattr(tflash, "_on_cpu", lambda t: False)
    monkeypatch.setattr(_kernels, "flash_fixed",
                        lambda q, k, v, o, qscale: calls.append((q, k, o)))
    shape = (2, 100, 4, 40) if layout == "bshd" else (2, 4, 100, 40)
    q = torch.zeros(shape, dtype=torch.bfloat16)
    k = torch.zeros(shape[:1] + ((SK, 4) if layout == "bshd" else (4, SK))
                    + shape[3:], dtype=torch.bfloat16)
    fn = tflash.flash_attention_fixed_bshd if layout == "bshd" \
        else tflash.flash_attention_fixed
    out = fn(q, k, k)
    (qv, kv, ov), = calls
    assert qv.shape == ov.shape == (2, 100, 4, 40)
    assert kv.shape == (2, SK, 4, 40)
    assert qv.data_ptr() == q.data_ptr() and ov.data_ptr() == out.data_ptr()


def test_attn_debug_prints_the_logit_bound(monkeypatch, capsys):
    """``SDBC_ATTN_DEBUG=1`` makes the head-major fixed-cap entry print the
    JAX package's per-call bound scale·max‖q‖·max‖k‖ (fp32); without the
    switch nothing prints, and the output is the same either way."""
    q, k, v = _near_cap()
    scale = 40 ** -0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    monkeypatch.delenv("SDBC_ATTN_DEBUG", raising=False)
    quiet = tflash.flash_attention_fixed(tq, tk, tv, scale=scale)
    assert capsys.readouterr().out == ""
    monkeypatch.setenv("SDBC_ATTN_DEBUG", "1")
    loud = tflash.flash_attention_fixed(tq, tk, tv, scale=scale)
    printed = capsys.readouterr().out
    assert torch.equal(quiet, loud)
    want = scale * np.sqrt((q.astype(np.float64) ** 2).sum(-1)).max() \
        * np.sqrt((k.astype(np.float64) ** 2).sum(-1)).max()
    assert tflash.logit_bound(tq, tk, scale) == pytest.approx(want, rel=1e-5)
    head, _, tail = printed.partition("logit upper bound ")
    value, _, rest = tail.partition(" ")
    assert head == "[sdbc flash-fixed] " and rest == (
        "(exact while <= 41.6; if larger use SDBC_ATTN_IMPL=xla)\n")
    assert abs(float(value) - want) <= 0.05 + 1e-4 * want  # printed .1f
    assert 36.0 < want  # the near-cap inputs: q and the late keys aligned

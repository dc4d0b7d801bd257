"""The fused GroupNorm (K8), the transposed-layout flash attention (K9), the
int8-QK fixed-cap attention (K10) and the attention / GroupNorm dispatch of
sdbc_tpu_torch against sdbc_tpu, on the CPU at small sizes in fp32.

The JAX Pallas kernels run in interpret mode off-TPU, as in test_ops.py.  On
a CPU tensor the port's wrappers compute their plain versions;
tests/test_torch_kernels.py compares each CUDA kernel with its plain version
on the card.  The dispatch tests patch both packages' device checks to
"accelerator present" and replace every kernel entry point with a recorder,
so they compare routes, not numbers.
"""
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.ops import attention as jattn
from sdbc_tpu.ops import flash_attention as jflash
from sdbc_tpu.ops import flash_attention_tt as jtt
from sdbc_tpu.ops import nn as jnn
from sdbc_tpu.ops import pallas_groupnorm as jpgn
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.ops import attention as tattn
from sdbc_tpu_torch.ops import flash_attention as tflash
from sdbc_tpu_torch.ops import flash_attention_tt as ttt
from sdbc_tpu_torch.ops import nn as tnn
from sdbc_tpu_torch.ops import pallas_groupnorm as tpgn
from tests.torch_threads import one_thread  # noqa: F401

# fp32 on both sides: summation order only
GN_ATOL, GN_GRAD_ATOL = 1e-5, 1e-4
TT_ATOL, TT_GRAD_ATOL = 2e-5, 1e-4


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# K8: fused GroupNorm(+SiLU)


@pytest.mark.parametrize("act,eps,shape,groups,pdtype", [
    (None, 1e-6, (2, 8, 8, 32), 8, "float32"),
    ("silu", 1e-5, (2, 8, 8, 32), 8, "float32"),
    # C/G = 3: groups straddle the kernel's 8-channel vectors
    ("silu", 1e-5, (2, 10, 20, 96), 32, "float32"),
    # scale and bias in bf16, as the bf16 UNet hands them to the kernel
    ("silu", 1e-5, (2, 8, 8, 32), 8, "bfloat16"),
    (None, 1e-6, (2, 10, 20, 96), 32, "bfloat16")],
    ids=["None-1e-06", "silu-1e-05", "silu-c96-g32", "silu-bf16-params",
         "None-c96-g32-bf16-params"])
def test_fused_group_norm_matches_jax(act, eps, shape, groups, pdtype):
    """At the JAX kernel test's shape, (2, 8, 8, 32) with 8 groups, at C/G
    = 3 and with bf16 scale and bias; the same numpy inputs through the JAX
    package's Pallas kernel in interpret mode.  x is fp32 on both sides:
    the outputs within GN_ATOL, the gradients of x within GN_GRAD_ATOL, and
    the bf16 gradients of scale and bias within one bf16 rounding of the
    larger (2^-8 of it) plus GN_GRAD_ATOL, since the two packages round the
    fp32 sums to bf16 from sums taken in other orders (at C = 96, 1e-6
    of the fp32 ones)."""
    c = shape[-1]
    x = _rand(30, *shape, scale=2.0) + 0.5
    jp = {"scale": jnp.asarray(_rand(31, c) * 0.3 + 1.3, pdtype),
          "bias": jnp.asarray(_rand(32, c) * 0.2, pdtype)}

    def jloss(x, p):
        return jnp.sum(jpgn.fused_group_norm(p, x, groups, eps, act) ** 2)

    jy = jpgn.fused_group_norm(jp, jnp.asarray(x), groups, eps, act)
    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)

    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[pdtype]
    tx = _t(x, True)
    ts, tb = (torch.from_numpy(np.array(jp[k], np.float32)).to(tdt)
              .requires_grad_(True) for k in ("scale", "bias"))
    _kernels.reset_launch_counts()
    y = tpgn.fused_group_norm(tx, ts, tb, groups, eps, act)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=GN_ATOL)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               atol=GN_GRAD_ATOL)
    # the scale and bias gradients sum over every row: ~500 at C = 96, where
    # fp32 summation order shows at 1e-6 of them
    rtol = 2.0 ** -8 if pdtype == "bfloat16" else 1e-6 if c == 96 else 1e-7
    for got, want in ((ts.grad, jgp["scale"]), (tb.grad, jgp["bias"])):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=GN_GRAD_ATOL, rtol=rtol)
    assert _kernels.launches["gn_fused"] == 0  # a CPU tensor: the plain version


def test_group_norm_fused_ref_is_group_norm():
    """The kernel's formula (one-pass variance) against F.group_norm's."""
    x = _t(_rand(33, 3, 5, 7, 64))
    w, b = _t(_rand(34, 64)), _t(_rand(35, 64))
    for act in (None, "silu"):
        torch.testing.assert_close(
            tpgn.group_norm_fused_ref(x, w, b, 16, 1e-6, act),
            tnn.group_norm(x, w, b, 16, 1e-6, act), atol=2e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# K9: transposed-layout flash attention


def test_flash_attention_tt_matches_jax():
    """At the JAX test's shape: (1, 2, 128, 24) queries over 77 keys."""
    q, k, v = _rand(20, 1, 2, 128, 24), _rand(21, 1, 2, 77, 24), \
        _rand(22, 1, 2, 77, 24)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))

    def jloss(q, k, v):
        return jnp.sum(jtt.flash_attention_tt(q, k, v) ** 2)

    jout = jtt.flash_attention_tt(jq, jk, jv)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = ttt.flash_attention_tt(tq, tk, tv)
    assert type(out.grad_fn).__name__ == "_FlashTTBackward"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=TT_ATOL)
    (out ** 2).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TT_GRAD_ATOL)


def test_to_tt_is_the_jax_layout():
    x = _t(_rand(23, 2, 3, 13, 16))
    xt = ttt.to_tt(x)
    assert tuple(xt.shape) == (2, 3, 16, 16) and xt.is_contiguous()
    torch.testing.assert_close(xt[..., :13], x.transpose(-1, -2))
    assert xt[..., 13:].abs().max().item() == 0  # zero-padded sequence


def test_flash_attention_tt_causal_is_plain():
    q = _t(_rand(24, 1, 2, 20, 8))
    torch.testing.assert_close(
        ttt.flash_attention_tt(q, q, q, causal=True),
        tattn.plain_attention(q, q, q, causal=True), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K10: int8 QKᵀ fixed-cap attention


def _jax_quant(x):
    """The JAX wrapper's ``quant`` (sdbc_tpu/ops/flash_attention.py:463-467)."""
    ax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1, keepdims=True)
    s = jnp.maximum(ax, 1e-8) / 127.0
    return jnp.round(x.astype(jnp.float32) / s).astype(jnp.int8), s


def test_fixed_cap_int8_ref_matches_jax():
    """(B, H, Sq, D, Sk) = (1, 2, 512, 40, 512): block sizes divide the
    sequences, as the JAX wrapper needs (it drops a ragged KV tail; the
    port masks it)."""
    q, k, v = _rand(40, 1, 2, 512, 40), _rand(41, 1, 2, 512, 40), \
        _rand(42, 1, 2, 512, 40)
    scale = 40 ** -0.5
    for x in (q, k):
        ji, js = _jax_quant(jnp.asarray(x))
        ti, ts = tflash.quantize_rows(_t(x))
        assert ti.dtype == torch.int8
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    ref = np.asarray(jflash._flash_fixed_fwd_int8(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, 256, 256))
    out = tflash.flash_attention_fixed_int8(_t(q), _t(k), _t(v))
    assert out.shape == (1, 2, 512, 40)
    err = np.abs(out.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max() + 1e-6, err
    # within JAX's own bound of exact attention (tests/test_ops.py)
    exact = tattn.plain_attention(_t(q), _t(k), _t(v)).numpy()
    assert np.abs(out.numpy() - exact).max() / np.abs(exact).max() < 0.04


def test_fixed_cap_int8_ref_masks_a_ragged_tail():
    """77 keys: the plain version (and the kernel) use all of them."""
    q = _t(_rand(43, 1, 1, 64, 16))
    k, v = _t(_rand(44, 1, 1, 77, 16)), _t(_rand(45, 1, 1, 77, 16))
    out = tflash.flash_attention_fixed_int8(q, k, v)
    exact = tattn.plain_attention(q, k, v)
    assert (out - exact).abs().max() / exact.abs().max() < 0.04
    assert (out - tattn.plain_attention(q, k[:, :, :64], v[:, :, :64])) \
        .abs().max() > 1e-2  # the last 13 keys count


@pytest.mark.parametrize("sq", [256, 300])
@pytest.mark.parametrize("d", [40, 80])
def test_int8_wrapper_hands_the_views_to_the_kernel(monkeypatch, sq, d):
    """The CUDA path's host side, the launch replaced by a recorder: q (a
    view of the projection layout), k and v go to the kernels as they are,
    with no copy and no quantization in torch; the output is a contiguous
    bf16 (B, H, Sq, D) tensor, and the pre-pass's buffers are int8
    (B, H, Sk, D rounded up to 16) and fp32 (B, H, Sk rounded up to 128)."""
    calls = []
    monkeypatch.setattr(tflash, "_on_cpu", lambda t: False)
    monkeypatch.setattr(_kernels, "flash_fixed_int8",
                        lambda *args: calls.append(args))
    bf = torch.bfloat16
    q = torch.zeros(2, sq, 4, d, dtype=bf).transpose(1, 2)
    k, v = torch.zeros(2, 4, 333, d, dtype=bf), torch.zeros(2, 4, 333, d,
                                                             dtype=bf)
    out = tflash.flash_attention_fixed_int8(q, k, v)
    (cq, ck, cv, co, k8, ks, qscale), = calls
    assert cq is q and ck is k and cv is v and co is out
    assert out.shape == q.shape and out.dtype == bf and out.is_contiguous()
    assert qscale == pytest.approx(d ** -0.5 * tflash.LOG2E, rel=1e-12)
    assert k8.dtype == torch.int8 and k8.shape == (2, 4, 333, 48 if d == 40
                                                   else 80)
    assert ks.dtype == torch.float32 and ks.shape == (2, 4, 384)


# ---------------------------------------------------------------------------
# dispatch: the same settings route to the same places in both packages


@pytest.fixture
def routes(monkeypatch):
    """Both packages with an accelerator "present" and every attention
    entry point replaced by a recorder; returns (port log, JAX log)."""
    for var in ("SDBC_ATTN_IMPL", "SDBC_ATTN_CROSS", "SDBC_FLASH_MAX_ROWS"):
        monkeypatch.delenv(var, raising=False)
    logs = ([], [])

    def rec(log, name):
        def entry(q, k, v, **kw):
            log.append(name)
            return q
        return entry

    monkeypatch.setattr(tattn, "_on_cuda", lambda t: True)
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    for log, mods in ((logs[0], (tattn, tflash, ttt)),
                      (logs[1], (jattn, jflash, jtt))):
        att, fl, tt = mods
        monkeypatch.setattr(fl, "flash_attention_fixed", rec(log, "fixed"))
        monkeypatch.setattr(fl, "flash_attention_fixed_bshd",
                            rec(log, "fixed_bshd"))
        monkeypatch.setattr(fl, "flash_attention", rec(log, "flash"))
        monkeypatch.setattr(tt, "flash_attention_tt", rec(log, "flash_tt"))
    monkeypatch.setattr(tattn, "plain_attention", rec(logs[0], "plain"))
    monkeypatch.setattr(jattn, "xla_attention", rec(logs[1], "plain"))
    return logs


def _dispatch_calls(entry, qshape, sk, causal, impl):
    """(q shape, k shape) and the two packages' calls of one route case."""
    b, h, sq, d = qshape
    if entry == "bshd":
        shapes = ((b, sq, h, d), (b, sk, h, d))
        calls = (lambda q, k: tattn.attention_bshd_inference(q, k, k),
                 lambda q, k: jattn.attention_bshd_inference(q, k, k))
    else:
        shapes = ((b, h, sq, d), (b, h, sk, d))
        calls = (lambda q, k: tattn.attention(q, k, k, causal=causal,
                                              impl=impl),
                 lambda q, k: jattn.attention(q, k, k, causal=causal,
                                              impl=impl))
    return shapes, calls


# (env, entry, impl, (b, h, sq, d), sk, causal, expected route)
DISPATCH = [
    ({}, "attn", "auto", (2, 8, 4096, 40), 4096, False, "flash"),
    ({}, "attn", "auto", (2, 8, 4096, 40), 77, False, "plain"),
    ({}, "attn", "auto", (2, 8, 64, 160), 64, False, "plain"),
    ({}, "attn", "auto", (1, 1, 4096, 512), 4096, False, "plain"),
    ({}, "attn", "auto", (16, 8, 4096, 8), 4096, False, "plain"),
    ({}, "attn", "auto", (2, 8, 256, 160), 256, True, "flash"),
    ({"SDBC_ATTN_CROSS": "flash"}, "attn", "auto", (2, 8, 4096, 40), 77,
     False, "flash"),
    ({"SDBC_FLASH_MAX_ROWS": "1000"}, "attn", "auto", (2, 8, 4096, 40), 4096,
     False, "plain"),
    ({}, "attn", "inference", (8, 8, 4096, 40), 4096, False, "fixed"),
    ({}, "attn", "inference", (8, 8, 4096, 40), 77, False, "plain"),
    ({}, "bshd", "inference", (8, 8, 4096, 40), 4096, False, "fixed_bshd"),
    ({}, "bshd", "inference", (8, 8, 4096, 40), 77, False, "plain"),
    ({"SDBC_ATTN_IMPL": "xla"}, "attn", "auto", (2, 8, 4096, 40), 4096,
     False, "plain"),
    ({"SDBC_ATTN_IMPL": "xla"}, "bshd", "inference", (8, 8, 4096, 40), 4096,
     False, "plain"),
    ({"SDBC_ATTN_IMPL": "flash"}, "attn", "auto", (1, 1, 4096, 512), 4096,
     False, "flash"),
    ({"SDBC_ATTN_IMPL": "flash"}, "attn", "inference", (2, 8, 4096, 40), 77,
     False, "flash"),
    ({"SDBC_ATTN_IMPL": "flash_tt"}, "attn", "auto", (2, 8, 64, 160), 77,
     False, "flash_tt"),
    ({"SDBC_ATTN_IMPL": "flash_tt"}, "bshd", "inference", (8, 8, 4096, 40),
     4096, False, "flash_tt"),
    ({"SDBC_ATTN_IMPL": "flash_tt"}, "attn", "xla", (2, 8, 4096, 40), 4096,
     False, "plain"),
    ({"SDBC_ATTN_IMPL": "xla"}, "attn", "flash_tt", (1, 1, 4096, 512), 4096,
     False, "flash_tt"),
    # the VAE's 512-wide head under "inference", head dims that are no
    # multiple of 8: the kernels' routes in both packages (the port's
    # wrappers then take their CUDA-core kernels, KERNEL_CHOICE below)
    ({}, "attn", "inference", (1, 1, 4096, 512), 4096, False, "fixed"),
    ({"SDBC_ATTN_IMPL": "inference"}, "attn", "auto", (1, 1, 4096, 512),
     4096, False, "fixed"),
    ({}, "bshd", "inference", (1, 1, 4096, 512), 4096, False, "fixed_bshd"),
    ({}, "attn", "auto", (2, 8, 4096, 44), 4096, False, "flash"),
    ({}, "bshd", "inference", (8, 8, 4096, 44), 4096, False, "fixed_bshd"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("env,entry,impl,qshape,sk,causal,want", DISPATCH)
def test_attention_dispatch_routes_as_jax(routes, monkeypatch, env, entry,
                                          impl, qshape, sk, causal, want,
                                          dtype):
    """The rules read no dtype: fp32 and bf16 on the port's side route as
    fp32 does on the JAX side."""
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    shapes, calls = _dispatch_calls(entry, qshape, sk, causal, impl)
    dt = getattr(torch, dtype)
    calls[0](torch.zeros(shapes[0], dtype=dt), torch.zeros(shapes[1],
                                                           dtype=dt))
    calls[1](np.zeros(shapes[0], np.float32), np.zeros(shapes[1], np.float32))
    assert routes[0] == routes[1] == [want]


# Each kernel entry point on a CUDA tensor (the device check stubbed, the
# launches replaced by recorders): its tensor-core kernel for what that
# takes (bf16, head dims a multiple of 8 up to 512; above 256 the wide
# kernels; the forwards in fp32 up to 512 (above 256 the wide one) and the
# backward in fp32 up to 160 the 3xTF32 kernels), the CUDA-core kernel of
# the same function for the rest.
# (entry, dtype, head dim, the launches of one call)
KERNEL_CHOICE = [
    ("fixed", "bfloat16", 40, ["flash_fixed"]),
    ("fixed", "float32", 40, ["flash_fixed_tf32"]),
    ("fixed", "bfloat16", 512, ["flash_fixed_wide"]),
    ("fixed", "bfloat16", 44, ["flash_fixed_simt"]),
    ("fixed_bshd", "bfloat16", 40, ["flash_fixed"]),
    ("fixed_bshd", "float32", 40, ["flash_fixed_tf32"]),
    ("fixed_bshd", "bfloat16", 512, ["flash_fixed_wide"]),
    ("fwd", "bfloat16", 40, ["flash_fwd"]),
    ("fwd", "bfloat16", 512, ["flash_fwd_wide"]),
    ("fwd", "float32", 40, ["flash_fwd_tf32"]),
    ("fwd", "float32", 512, ["flash_fwd_tf32_wide"]),
    ("fwd", "bfloat16", 44, ["flash_fwd_simt"]),
    ("tt", "bfloat16", 40, ["flash_fwd_tt"]),
    ("tt", "float32", 40, ["flash_fwd_tf32"]),
    ("tt", "float32", 264, ["flash_fwd_tf32_wide"]),
    ("bwd", "bfloat16", 40, ["flash_bwd_dq", "flash_bwd_dkv"]),
    ("bwd", "bfloat16", 512, ["flash_bwd_dq_wide", "flash_bwd_dkv_wide"]),
    ("bwd", "float32", 40, ["flash_bwd_dq_tf32", "flash_bwd_dkv_tf32"]),
    ("bwd", "float32", 160, ["flash_bwd_dq_tf32", "flash_bwd_dkv_tf32"]),
    ("bwd", "float32", 192, ["flash_simt_bwd_dq", "flash_simt_bwd_dkv"]),
    ("bwd", "float32", 44, ["flash_simt_bwd_dq", "flash_simt_bwd_dkv"]),
    ("bwd", "bfloat16", 44, ["flash_simt_bwd_dq", "flash_simt_bwd_dkv"]),
    ("fixed", "float32", 256, ["flash_fixed_tf32"]),
    ("fixed", "float32", 264, ["flash_fixed_tf32_wide"]),
    ("fixed", "float32", 44, ["flash_fixed_simt"]),
    ("fwd", "float32", 160, ["flash_fwd_tf32"]),
    ("fwd", "float32", 44, ["flash_fwd_simt"]),
]

_LAUNCHERS = ("flash_fixed", "flash_fixed_wide", "flash_fwd",
              "flash_fwd_wide", "flash_fwd_tt",
              "flash_fwd_tt_wide", "flash_bwd_dq", "flash_bwd_dkv",
              "flash_bwd_dq_wide", "flash_bwd_dkv_wide", "flash_simt_bwd_dq",
              "flash_simt_bwd_dkv", "flash_bwd_dq_tf32", "flash_bwd_dkv_tf32")


@pytest.fixture
def launched(monkeypatch):
    """CUDA tensors "present" to the flash wrappers, every launcher of
    ``_kernels`` replaced by a recorder; returns the log of launches."""
    log = []
    monkeypatch.setattr(tflash, "_on_cpu", lambda t: False)
    for name in _LAUNCHERS:
        monkeypatch.setattr(_kernels, name,
                            lambda *a, name=name, **kw: log.append(name))
    monkeypatch.setattr(
        _kernels, "flash_simt_fwd", lambda *a, fixed: log.append(
            "flash_fixed_simt" if fixed else "flash_fwd_simt"))
    monkeypatch.setattr(
        _kernels, "flash_tf32", lambda *a, fixed: log.append(
            "flash_fixed_tf32" if fixed else "flash_fwd_tf32"))
    monkeypatch.setattr(
        _kernels, "flash_tf32_wide", lambda *a, fixed: log.append(
            "flash_fixed_tf32_wide" if fixed else "flash_fwd_tf32_wide"))
    return log


def _call_entry(entry, dtype, d):
    from sdbc_tpu_torch.ops import flash_attention_bwd as tbwd

    dt = getattr(torch, dtype)
    q = torch.zeros(1, 2, 64, d, dtype=dt)
    if entry == "fixed":
        return tflash.flash_attention_fixed(q, q, q)
    if entry == "fixed_bshd":
        return tflash.flash_attention_fixed_bshd(*(q.transpose(1, 2),) * 3)
    if entry == "fwd":
        return tflash.flash_fwd(q, q, q, d ** -0.5)
    if entry == "tt":
        return ttt.flash_fwd_tt(q, q, q, d ** -0.5)
    return tbwd.flash_bwd(q, q, q, q, q, torch.zeros(1, 2, 64), d ** -0.5)


@pytest.mark.parametrize("entry,dtype,d,want", KERNEL_CHOICE)
def test_wrappers_launch_the_kernel_that_takes_the_tensors(launched, entry,
                                                           dtype, d, want):
    _call_entry(entry, dtype, d)
    assert launched == want


@pytest.mark.parametrize("entry", ["fixed", "fwd", "tt", "bwd"])
@pytest.mark.parametrize("dtype,d,err", [("float16", 40, TypeError),
                                         ("bfloat16", 520, ValueError)])
def test_wrappers_refuse_what_no_kernel_takes(launched, entry, dtype, d,
                                              err):
    with pytest.raises(err, match="flash_simt"):
        _call_entry(entry, dtype, d)
    assert launched == []


@pytest.mark.parametrize("impl", ["auto", "inference"])
def test_unknown_attention_override_raises(routes, monkeypatch, impl):
    monkeypatch.setenv("SDBC_ATTN_IMPL", "flash2")
    q = np.zeros((1, 1, 256, 8), np.float32)
    with pytest.raises(ValueError, match="flash2"):
        tattn.attention(torch.from_numpy(q), torch.from_numpy(q),
                        torch.from_numpy(q), impl=impl)
    with pytest.raises(ValueError, match="flash2"):
        jattn.attention(q, q, q, impl=impl)
    with pytest.raises(ValueError, match="bogus"):
        tattn.attention(torch.from_numpy(q), torch.from_numpy(q),
                        torch.from_numpy(q), impl="bogus")


def _jax_eligible(x, g):
    with unittest.mock.patch.object(jax, "default_backend",
                                    return_value="tpu"):
        return _JAX_ELIGIBLE(x, g)


_JAX_ELIGIBLE = jpgn.eligible

# (shape, groups): the UNet's and VAE's GroupNorm inputs at SD-1.5 512²
# (per sample), the 6 MiB boundary, and channels that do not divide
GN_SHAPES = [((2, 8, 8, 32), 8), ((1, 64, 64, 320), 32),
             ((1, 64, 64, 640), 32), ((1, 64, 64, 960), 32),
             ((1, 32, 32, 1280), 32), ((1, 32, 32, 1920), 32),
             ((1, 16, 16, 2560), 32), ((1, 8, 8, 1280), 32),
             ((1, 64, 64, 384), 32), ((1, 64, 64, 392), 8),
             ((1, 64, 64, 512), 32), ((2, 8, 8, 36), 8)]


@pytest.mark.parametrize("shape,groups", GN_SHAPES)
def test_group_norm_eligibility_is_jax(monkeypatch, shape, groups):
    monkeypatch.setattr(tpgn, "_on_cuda", lambda x: True)
    got = tpgn.eligible(torch.empty(shape), groups)
    assert got == _jax_eligible(np.empty(shape, np.float32), groups)
    assert got == tpgn.fits(shape, groups)
    monkeypatch.setattr(tpgn, "_on_cuda", lambda x: False)
    assert not tpgn.eligible(torch.empty(shape), groups)


@pytest.mark.parametrize("env,act,shape,want", [
    ("1", None, (2, 8, 8, 32), "fused"), ("1", "silu", (2, 8, 8, 32), "fused"),
    ("0", "silu", (2, 8, 8, 32), "plain"), (None, "silu", (2, 8, 8, 32),
                                            "plain"),
    ("1", "silu", (1, 64, 64, 392), "plain")])
def test_group_norm_dispatch_routes_as_jax(monkeypatch, env, act, shape,
                                           want):
    if env is None:
        monkeypatch.delenv("SDBC_GN_FUSED", raising=False)
    else:
        monkeypatch.setenv("SDBC_GN_FUSED", env)
    logs = ([], [])

    def rec(log):
        def entry(*args, **kw):
            log.append("fused")
            x = [a for a in args if getattr(a, "ndim", 0) == len(shape)][0]
            return x
        return entry

    monkeypatch.setattr(tpgn, "_on_cuda", lambda x: True)
    monkeypatch.setattr(tpgn, "fused_group_norm", rec(logs[0]))
    monkeypatch.setattr(jpgn, "eligible", _jax_eligible)
    monkeypatch.setattr(jpgn, "fused_group_norm", rec(logs[1]))
    c, g = shape[-1], 8
    x = _rand(50, *shape)
    tnn.group_norm(_t(x), torch.ones(c), torch.zeros(c), g, 1e-6, act)
    jnn.group_norm({"scale": jnp.ones(c), "bias": jnp.zeros(c)},
                   jnp.asarray(x), g, 1e-6, act)
    assert logs[0] == logs[1] == ([want] if want == "fused" else [])


def test_group_norm_unknown_act_raises_with_the_switch(monkeypatch):
    monkeypatch.setenv("SDBC_GN_FUSED", "1")
    monkeypatch.setattr(tpgn, "_on_cuda", lambda x: True)
    with pytest.raises(ValueError, match="unknown act"):
        tnn.group_norm(torch.zeros(1, 4, 4, 8), torch.ones(8), torch.zeros(8),
                       4, 1e-6, "gelu")


@pytest.mark.parametrize("dtype,c,sm90", [
    (torch.bfloat16, 320, True), (torch.float32, 320, False),
    (torch.bfloat16, 48, False), (torch.bfloat16, 352, False),
    (torch.bfloat16, 640, True), (torch.float32, 40, False)])
def test_geglu_takes_the_kernel_that_takes_the_rows(dtype, c, sm90):
    """The fused FF's eligibility is the JAX package's for every dtype; the
    tensor-core kernel takes bf16 rows of c a multiple of 32 (of 64 above
    320), the CUDA-core kernel (any width up to 640, bf16 or fp32) the
    others, and the tensor-core kernel's input check refuses those."""
    from sdbc_tpu_torch.ops import geglu_ff as tgeglu

    args = _geglu_args(256, c, dtype)
    assert tgeglu.takes(args[0]) == sm90 and tgeglu.takes_simt(args[0])
    tgeglu._check_cuda_inputs(
        *args, kernel="geglu_ff" if sm90 else "geglu_ff_simt")
    if not sm90:
        with pytest.raises(ValueError, match="tensor-core kernel takes"):
            tgeglu._check_cuda_inputs(*args)


def _geglu_args(rows, c, dtype):
    z = lambda *sh, dt=dtype: torch.zeros(sh, dtype=dt)
    return (z(rows, c), z(c, dt=torch.float32), z(c, dt=torch.float32),
            z(c, 8 * c), z(8 * c), z(4 * c, c), z(c))


def test_pipeline_attn_impl_forces_plain_attention(monkeypatch):
    """``SDPipeline(attn_impl="xla")`` sends every UNet attention call to
    ``plain_attention``, as ``SDBC_ATTN_IMPL=xla`` does, with the same
    images; the default sends them to the fixed-cap kernel's entry points
    (each computes its plain version on a CPU tensor)."""
    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
    from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig, SDPipeline,
                                                   init_models)

    monkeypatch.delenv("SDBC_ATTN_IMPL", raising=False)
    monkeypatch.setattr(tattn, "_on_cuda", lambda t: True)
    calls = {}

    def counting(mod, name):
        orig = getattr(mod, name)

        def entry(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return orig(*args, **kw)
        monkeypatch.setattr(mod, name, entry)

    for mod, name in ((tflash, "flash_attention_fixed"),
                      (tflash, "flash_attention_fixed_bshd"),
                      (tflash, "flash_attention"),
                      (ttt, "flash_attention_tt"),
                      (tattn, "plain_attention")):
        counting(mod, name)
    cfg = PipelineConfig.tiny()
    models = init_models(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    tok = CLIPTokenizer.fallback(cfg.clip.vocab_size)
    kw = dict(height=32, width=32, num_inference_steps=2, seed=3)

    def run(**pipe_kw):
        calls.clear()
        out = SDPipeline(models, cfg, tok, "cpu", torch.float32,
                         **pipe_kw)(["a book cover"], **kw)
        return out, dict(calls)

    forced, forced_calls = run(attn_impl="xla")
    monkeypatch.setenv("SDBC_ATTN_IMPL", "xla")
    env, env_calls = run()
    monkeypatch.delenv("SDBC_ATTN_IMPL")
    default, default_calls = run()
    fixed = ("flash_attention_fixed", "flash_attention_fixed_bshd")
    assert not any(forced_calls.get(n) or env_calls.get(n) for n in fixed)
    assert sum(default_calls.get(n, 0) for n in fixed) > 0
    # the UNet's attention calls all go to plain attention under both; the
    # VAE keeps its own "auto" dispatch under attn_impl (its one mid-block
    # call takes the training flash entry), the variable overrides it too
    assert forced_calls["plain_attention"] == env_calls["plain_attention"] - 1
    assert forced_calls.get("flash_attention") == 1
    assert "flash_attention" not in env_calls
    np.testing.assert_allclose(forced, env, atol=1e-5)
    assert forced.shape == (1, 32, 32, 3) and np.isfinite(forced).all()

"""sdbc_tpu_torch ops against sdbc_tpu ops, on the CPU at small sizes.

The same numpy inputs (seeded) go through the JAX function and its port;
the JAX Pallas kernels run in interpret mode off-TPU, as in test_ops.py.
On a CPU tensor the port's kernel wrappers compute their plain PyTorch
versions; tests/test_torch_kernels.py holds the card-only comparisons of
each CUDA kernel with its plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.ops import attention as jattn
from sdbc_tpu.ops import flash_attention as jflash
from sdbc_tpu.ops import geglu_ff as jgeglu
from sdbc_tpu.ops import nn as jnn
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.ops import attention as tattn
from sdbc_tpu_torch.ops import flash_attention as tflash
from sdbc_tpu_torch.ops import geglu_ff as tgeglu
from sdbc_tpu_torch.ops import nn as tnn
from tests.torch_threads import one_thread  # noqa: F401

# fp32 tolerances of tests/test_ops.py for the kernels they mirror
FLASH_TOL = dict(atol=2e-5, rtol=2e-5)
GEGLU_TOL = dict(atol=5e-4, rtol=1e-4)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# ops/nn.py primitives


def test_linear_matches_jax():
    x, w, b = _rand(0, 2, 5, 8), _rand(1, 8, 6), _rand(2, 6)
    ref = jnn.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x))
    out = tnn.linear(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("stride,padding,kernel", [(1, "SAME", 3),
                                                   (2, 1, 3),
                                                   (1, "SAME", 1)])
def test_conv2d_matches_jax(stride, padding, kernel):
    x = _rand(3, 2, 8, 8, 6)
    w, b = _rand(4, kernel, kernel, 6, 5, scale=0.3), _rand(5, 5)  # HWIO
    ref = jnn.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x), stride=stride, padding=padding)
    out = tnn.conv2d(_t(x), _t(w), _t(b), stride,
                     padding)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_matches_jax(eps, act):
    x = _rand(6, 2, 4, 4, 16, scale=2.0) + 0.5
    p = {"scale": _rand(7, 16) * 0.2 + 1.0, "bias": _rand(8, 16) * 0.1}
    ref = jnn.group_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), 4,
                         eps=eps, act=act)
    out = tnn.group_norm(_t(x), _t(p["scale"]), _t(p["bias"]), 4, eps, act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_layer_norm_embedding_quick_gelu_match_jax():
    x = _rand(9, 2, 5, 16, scale=3.0) + 1.0
    p = {"scale": _rand(10, 16) * 0.2 + 1.0, "bias": _rand(11, 16) * 0.1}
    ref = jnn.layer_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    out = tnn.layer_norm(_t(x), _t(p["scale"]), _t(p["bias"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)

    table, ids = _rand(12, 10, 4), np.array([[0, 3, 9], [2, 2, 1]])
    np.testing.assert_array_equal(
        tnn.embedding(torch.from_numpy(ids), _t(table)).numpy(),
        np.asarray(jnn.embedding({"table": jnp.asarray(table)},
                                 jnp.asarray(ids))))
    np.testing.assert_allclose(tnn.quick_gelu(_t(x)).numpy(),
                               np.asarray(jnn.quick_gelu(jnp.asarray(x))),
                               atol=1e-6)


@pytest.mark.parametrize("dim", [32, 320, 7])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0, 1, 250, 999])
    ref = jnn.timestep_embedding(jnp.asarray(t), dim)
    out = tnn.timestep_embedding(torch.from_numpy(t), dim)
    # arguments reach ~1000 rad, where one fp32 ulp is 6e-5: the two
    # libraries' exp/sin/cos may differ by that much
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    if dim % 2 == 0:  # [cos | sin]: t=0 → cos half 1, sin half 0
        np.testing.assert_allclose(out[0, :dim // 2].numpy(), 1.0)
        np.testing.assert_allclose(out[0, dim // 2:].numpy(), 0.0)


def test_upsample_nearest_matches_jax():
    x = _rand(13, 1, 3, 2, 4)
    np.testing.assert_array_equal(
        tnn.upsample_nearest_2x(_t(x)).numpy(),
        np.asarray(jnn.upsample_nearest_2x(jnp.asarray(x))))


# ---------------------------------------------------------------------------
# attention


def test_plain_attention_matches_xla_attention():
    q, k, v = _rand(14, 1, 2, 9, 16), _rand(15, 1, 2, 12, 16), \
        _rand(16, 1, 2, 12, 16)
    for causal in (False, True):
        ref = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal)
        out = tattn.plain_attention(_t(q), _t(k), _t(v), causal=causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)


@pytest.mark.parametrize("sq", [256, 200])  # 200: the K3 (padded) path
@pytest.mark.parametrize("entry", ["flash_attention_fixed_bshd",
                                   "attention_bshd_inference"])
def test_fixed_cap_bshd_matches_pallas(sq, entry):
    b, h, d = 2, 4, 40
    q, k, v = (_rand(s, b, sq, h, d) for s in (17, 18, 19))
    ref = jflash.flash_attention_fixed_bshd(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    fn = (tflash.flash_attention_fixed_bshd
          if entry == "flash_attention_fixed_bshd"
          else tattn.attention_bshd_inference)
    out = fn(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FLASH_TOL)


@pytest.mark.parametrize("shape,sk", [((1, 2, 256, 40), 256),
                                      ((2, 1, 128, 80), 300)])
def test_fixed_cap_head_major_matches_pallas(shape, sk):
    q = _rand(20, *shape)
    kshape = shape[:2] + (sk, shape[3])
    k, v = _rand(21, *kshape), _rand(22, *kshape)
    ref = jflash.flash_attention_fixed(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v))
    out = tflash.flash_attention_fixed(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FLASH_TOL)


def test_fixed_cap_ref_keeps_bf16_rounding_points():
    """In bf16 the plain version rounds q after the prescale and p before
    the PV product, like the kernel; it stays close to fp32 softmax."""
    q, k, v = (_t(_rand(s, 1, 2, 64, 16)) for s in (23, 24, 25))
    out = tflash.fixed_cap_attention_ref(q.bfloat16(), k.bfloat16(),
                                         v.bfloat16())
    assert out.dtype == torch.bfloat16
    ref = tattn.plain_attention(q, k, v)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=3e-2)


def test_inference_dispatch_on_cpu_is_plain():
    q, k, v = (_t(_rand(s, 1, 2, 300, 40)) for s in (26, 27, 28))
    np.testing.assert_array_equal(
        tattn.attention(q, k, v, impl="inference").numpy(),
        tattn.plain_attention(q, k, v).numpy())
    with pytest.raises(ValueError):
        tattn.attention(q, k, v, impl="flash_tpu")


# ---------------------------------------------------------------------------
# fused GEGLU feed-forward


def _geglu_inputs(rows, c, seed=30):
    return (_rand(seed, rows, c), _rand(seed + 1, c) * 0.2 + 1.0,
            _rand(seed + 2, c) * 0.1, _rand(seed + 3, c, 8 * c, scale=c ** -0.5),
            _rand(seed + 4, 8 * c) * 0.05,
            _rand(seed + 5, 4 * c, c, scale=(4 * c) ** -0.5),
            _rand(seed + 6, c) * 0.05)


@pytest.mark.parametrize("split", [True, False])
def test_geglu_ff_ref_matches_pallas(split):
    args = _geglu_inputs(256, 64)
    ref = jgeglu._geglu_ff_rows(*(jnp.asarray(a) for a in args), 1e-5,
                                block=128, split=split)
    out = tgeglu.geglu_ff_ref(*(_t(a) for a in args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GEGLU_TOL)
    np.testing.assert_array_equal(
        tgeglu.geglu_ff_rows(*(_t(a) for a in args)).numpy(), out.numpy())


def test_geglu_ff_module_entry_matches_pallas():
    from sdbc_tpu_torch.ops.nn import LayerNorm, Linear

    y, gamma, beta, w1, b1, w2, b2 = _geglu_inputs(2 * 128, 32, seed=40)
    ref = jgeglu.geglu_ff(jnp.asarray(y.reshape(2, 128, 32)),
                          {"scale": jnp.asarray(gamma),
                           "bias": jnp.asarray(beta)},
                          {"w": jnp.asarray(w1), "b": jnp.asarray(b1)},
                          {"w": jnp.asarray(w2), "b": jnp.asarray(b2)})
    ln, up, down = (LayerNorm(32, device="cpu"), Linear(32, 256, device="cpu"),
                    Linear(128, 32, device="cpu"))
    with torch.no_grad():
        for p, a in ((ln.weight, gamma), (ln.bias, beta), (up.weight, w1),
                     (up.bias, b1), (down.weight, w2), (down.bias, b2)):
            p.copy_(_t(a))
        out = tgeglu.geglu_ff(_t(y).reshape(2, 128, 32), ln, up, down)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **GEGLU_TOL)


def test_ff_fused_eligible_mirrors_jax_rule_off_cuda():
    y = torch.zeros(2, 512, 320)
    assert not tgeglu.ff_fused_eligible(y)            # CPU tensor
    assert not tgeglu.ff_fused_eligible(y.to("meta"))  # not CUDA either


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.zeros(1, 256, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tflash.flash_attention_fixed_bshd(q, q, q)
    y = torch.zeros(32, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tgeglu.geglu_ff_rows(y, *([y] * 6))
    assert set(_kernels.launches.values()) == {0}

"""The training kernels' plain versions and wrappers in sdbc_tpu_torch
against sdbc_tpu, on the CPU at small sizes in fp32.

The JAX Pallas kernels run in interpret mode off-TPU, as in test_ops.py and
test_adam8bit.py.  On a CPU tensor the port's wrappers compute their plain
versions; tests/test_torch_kernels.py compares each CUDA kernel with its
plain version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdbc_tpu.ops import flash_attention as jflash
from sdbc_tpu.train import adam8bit as jadam8
from sdbc_tpu_torch.models.convert import load_adam8_state
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.ops import attention as tattn
from sdbc_tpu_torch.ops import flash_attention as tflash
from sdbc_tpu_torch.train import adam8bit as tadam8
from tests.torch_threads import one_thread  # noqa: F401

# fp32: summation order only (the JAX forward's own test uses 2e-5)
OUT_ATOL, LSE_ATOL = 2e-5, 1e-5
GRAD_ATOL = 2e-4  # test_flash_bwd_odd_shapes_match_xla's tolerance
PARAM_ATOL = 1e-6
SCALE_RTOL = 1e-6
MAX_INT8_OFF_BY_ONE = 1e-3  # share of moment entries allowed to differ by 1


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# K5: forward with LSE


@pytest.mark.parametrize("shape,sk", [((1, 2, 128, 16), 77),
                                      ((1, 2, 256, 40), 256),
                                      ((1, 2, 140, 8), 140)])
def test_flash_attention_ref_matches_jax_fwd(shape, sk):
    b, h, sq, d = shape
    q, k, v = _rand(1, *shape), _rand(2, b, h, sk, d), _rand(3, b, h, sk, d)
    scale = d ** -0.5
    jout, jlse = jflash._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), scale)
    out, lse = tflash.flash_attention_ref(_t(q), _t(k), _t(v), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=LSE_ATOL)
    # the wrapper takes the plain version for a CPU tensor
    _kernels.reset_launch_counts()
    out2, lse2 = tflash.flash_fwd(_t(q), _t(k), _t(v), scale)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    torch.testing.assert_close(lse2, lse, rtol=0, atol=0)
    assert set(_kernels.launches.values()) == {0}


# ---------------------------------------------------------------------------
# K6: the custom gradient


@pytest.mark.parametrize("sq,sk,d", [(256, 256, 40), (256, 77, 40),
                                     (140, 256, 8)])
def test_flash_attention_grads_match_jax(sq, sk, d):
    """Autograd through ``_FlashAttention`` (whose CPU backward is
    ``flash_bwd_ref``) against ``jax.grad`` of the JAX custom VJP."""
    q, k, v = (_rand(21, 1, 2, sq, d), _rand(22, 1, 2, sk, d),
               _rand(23, 1, 2, sk, d))

    def loss_jax(q, k, v):
        return jnp.sum(jflash.flash_attention(q, k, v) ** 2)

    jg = jax.grad(loss_jax, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tflash.flash_attention(tq, tk, tv)
    assert out.grad_fn is not None \
        and type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    (out ** 2).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL)


def test_auto_dispatch_follows_the_flash_rule():
    """On the CPU "auto" is plain attention; the eligibility rule is the
    JAX package's ``_flash_eligible``."""
    q = torch.zeros(2, 8, 4096, 40)
    k = torch.zeros(2, 8, 4096, 40)
    elig = tattn._flash_eligible
    assert not elig(q, k)  # a CPU tensor
    assert not tattn._flash_dispatch(q, k, False, -2)


# ---------------------------------------------------------------------------
# K7: the fused 8-bit AdamW step


def _adam8_trees():
    # 32768 elements (16 full rows), 40000 (a ragged last row), and a small
    # leaf that keeps fp32 moments
    return {"a": _rand(40, 16, 2048, scale=0.5),
            "b": _rand(41, 200, 200, scale=0.5),
            "c": _rand(42, 1000, scale=0.5)}


def _grads(step):
    return {"a": _rand(50 + step, 16, 2048, scale=0.1),
            "b": _rand(60 + step, 200, 200, scale=0.1),
            "c": _rand(70 + step, 1000, scale=0.1)}


def test_adam8_ref_matches_jax_from_a_mid_training_state():
    lr, wd = 1e-2, 1e-2
    jopt = jadam8.adamw8bit(lr, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in _adam8_trees().items()}
    jst = jopt.init(jp)
    for s in range(2):  # reach a mid-training state in JAX
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in
                                _grads(s).items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
    names = sorted(jp)  # the JAX flat order of a dict tree
    state = load_adam8_state(jax.tree.map(np.asarray, jst))
    assert state.count == 2
    assert [type(s).__name__ for s in state.per_leaf] == \
        ["Quant8State", "Quant8State", "FP32Moments"]
    assert state.per_leaf[1].ms.shape == (20,)  # 40000 → 20 rows
    params = [_t(np.asarray(jp[k])) for k in names]
    opt = tadam8.adamw8bit(lr, weight_decay=wd)
    for s in range(2, 5):
        g = _grads(s)
        upd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                               jst, jp)
        jp = optax.apply_updates(jp, upd)
        state = opt.update([_t(g[k]) for k in names], state, params)
    assert state.count == int(jst.count) == 5
    for k, p, st, jl in zip(names, params, state.per_leaf, jst.per_leaf):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]),
                                   atol=PARAM_ATOL, err_msg=k)
        if isinstance(st, tadam8.Quant8State):
            for q, jq in ((st.mq, jl.mq), (st.vq, jl.vq)):
                diff = np.abs(q.numpy().astype(np.int32)
                              - np.asarray(jq).astype(np.int32))
                assert diff.max() <= 1, k
                assert (diff > 0).mean() <= MAX_INT8_OFF_BY_ONE, k
            np.testing.assert_allclose(st.ms.numpy(), np.asarray(jl.ms)[:, 0],
                                       rtol=SCALE_RTOL)
            np.testing.assert_allclose(st.vs.numpy(), np.asarray(jl.vs)[:, 0],
                                       rtol=SCALE_RTOL)
        else:
            np.testing.assert_allclose(st.m.numpy(), np.asarray(jl.m),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(st.v.numpy(), np.asarray(jl.v),
                                       rtol=1e-6, atol=1e-12)


def test_adam8_stacks_the_clip_layers_as_jax_does():
    """The text encoder's per-layer parameters form one leaf per name, as
    the JAX tree stacks them: 3 layers of a 6000-wide fc1 bias make an
    18000-element leaf on the 8-bit path (one layer's 6000 would keep fp32
    moments), its 2048-element rows straddling the layers."""
    from sdbc_tpu.models import clip as jclip
    from sdbc_tpu_torch.models import clip as tclip
    from sdbc_tpu_torch.models.convert import (_flatten_jax_tree,
                                               load_jax_params)
    from sdbc_tpu_torch.train import trainer as ttrainer

    kw = dict(vocab_size=1000, hidden=32, layers=3, heads=4, mlp=6000,
              ctx=16)
    jp = jclip.init(jax.random.key(0), jclip.CLIPTextConfig(**kw))
    module = load_jax_params(tclip.init(tclip.CLIPTextConfig(**kw),
                                        device="cpu"),
                             jax.tree.map(np.asarray, jp))
    lr, wd = 1e-2, 1e-2
    jopt = jadam8.adamw8bit(lr, weight_decay=wd)
    jst = jopt.init(jp)
    leaves = ttrainer.optimizer_leaves({"text_encoder": module})
    opt = tadam8.adamw8bit(lr, weight_decay=wd)
    state = opt.init(leaves)
    assert len(leaves) == len(jst.per_leaf)
    names = {id(p): n for n, p in module.named_parameters()}
    fc1b = next(i for i, leaf in enumerate(leaves)
                if names[id(leaf[0])] == "layers.0.mlp.fc1.bias")
    assert module.layers[0].mlp.fc1.bias.numel() < tadam8.MIN_8BIT_SIZE
    assert [names[id(p)] for p in leaves[fc1b]] == \
        [f"layers.{i}.mlp.fc1.bias" for i in range(3)]
    assert state.per_leaf[fc1b].mq.shape == (9, 2048)  # 18000 → 9 rows
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    j_fc1b = paths.index("['layers']['mlp']['fc1']['b']")
    rng = np.random.default_rng(90)
    for step in range(3):
        gtree = jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                        * 0.1).astype(np.float32), jp)
        upd, jst = jopt.update(jax.tree.map(jnp.asarray, gtree), jst, jp)
        jp = optax.apply_updates(jp, upd)
        gflat = _flatten_jax_tree(module, gtree)
        state = opt.update([[_t(gflat[names[id(p)]]) for p in leaf]
                            for leaf in leaves], state, leaves)
        if step == 0:  # the moments of one step from the same zero state
            st, jl = state.per_leaf[fc1b], jst.per_leaf[j_fc1b]
            for q, jq in ((st.mq, jl.mq), (st.vq, jl.vq)):
                diff = np.abs(q.numpy().astype(np.int32)
                              - np.asarray(jq).astype(np.int32))
                assert diff.max() <= 1
                assert (diff > 0).mean() <= MAX_INT8_OFF_BY_ONE
            np.testing.assert_allclose(st.ms.numpy(), np.asarray(jl.ms)[:, 0],
                                       rtol=SCALE_RTOL)
    # an int8 moment entry one off (a rounding tie) moves its
    # element's later steps by a fraction of lr: such elements are held to
    # lr, the rest to PARAM_ATOL
    want = _flatten_jax_tree(module, jax.tree.map(np.asarray, jp))
    for name, p in module.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name])
        assert diff.max() <= lr, name
        assert (diff > PARAM_ATOL).mean() <= MAX_INT8_OFF_BY_ONE, name


def test_adam8_wrapper_on_cpu_is_the_plain_version():
    p = _t(_rand(80, 40000))
    g = _t(_rand(81, 40000, scale=0.1))
    opt = tadam8.adamw8bit(1e-3)
    st_a, st_b = opt.leaf_init(p), opt.leaf_init(p)
    pa, pb = p.clone(), p.clone()
    _kernels.reset_launch_counts()
    tadam8.adam8_update(pa, g, st_a, 1e-3, 1, b1=0.9, b2=0.999, eps=1e-8,
                        wd=1e-4)
    tadam8.adam8_update_ref(pb, g, st_b, 1e-3, 1, b1=0.9, b2=0.999, eps=1e-8,
                            wd=1e-4)
    assert set(_kernels.launches.values()) == {0}
    torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    torch.testing.assert_close(st_a.mq, st_b.mq, rtol=0, atol=0)
    # the ragged tail of the last row stays zero
    assert int(st_a.mq.reshape(-1)[40000:].abs().max()) == 0
    # first step moves every element by ~lr (bias-corrected Adam)
    assert float((pa - p).abs().max()) == pytest.approx(1e-3, rel=1e-2)

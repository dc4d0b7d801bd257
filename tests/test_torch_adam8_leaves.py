"""The one-launch 8-bit AdamW over every leaf of a step, held on the CPU.

``adam8_update_leaves_ref`` is the plain version of the multi-leaf kernel
(``csrc/adam8bit.cu``): it walks the step's global rows and addresses each
element as the kernel does (row → leaf by the leaves' first rows, element
i of a leaf → part i // part_n at i % part_n).  It must equal, bit for bit,
the per-leaf plain version (``adam8_update_ref``, held to the JAX package's
``adamw8bit`` in ``test_torch_train_ops.py``) run on stacked copies.  The
kernel meets the same leaves on the card in ``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.train import adam8bit as tadam8
from tests.torch_threads import one_thread  # noqa: F401

KW = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-2)
MIN8 = 4096  # min_8bit_size, below the reference's 16384: tiny leaves


def _t(seed, *shape, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))


# (parts, part shape): a leaf of full rows, one with a ragged last row, a
# stacked leaf whose 2048-element rows straddle its 3072-element parts (as
# the text encoder's 12 fc1 biases do), and a stacked leaf whose part
# length is no multiple of 16 (the kernel's element-by-element path)
LEAVES = [(1, (8, 2048)), (1, (5, 2048 + 200)), (4, (3072,)), (3, (3000,)),
          (1, (16384,))]


def _leaves(seed=0):
    return [[_t(seed + 10 * i + j, *shape, scale=0.5) for j in range(parts)]
            for i, (parts, shape) in enumerate(LEAVES)]


def _grads(leaves, seed):
    return [[_t(seed + 100 * i + j, *p.shape, scale=0.1)
             for j, p in enumerate(leaf)] for i, leaf in enumerate(leaves)]


def _states(leaves, opt):
    return [opt.leaf_init(leaf) for leaf in leaves]


def _stack(parts):
    return parts[0].clone() if len(parts) == 1 else torch.stack(parts)


def test_table_walk_matches_the_per_leaf_plain_version_bitwise():
    opt = tadam8.adamw8bit(1e-2, weight_decay=KW["wd"], min_8bit_size=MIN8)
    walk = _leaves()
    states = _states(walk, opt)
    assert all(isinstance(s, tadam8.Quant8State) for s in states)
    stacked = [_stack(leaf) for leaf in walk]
    per_leaf = [tadam8.Quant8State(*(x.clone() for x in (
        s.mq, s.ms, s.vq, s.vs))) for s in states]
    for step in range(1, 4):  # from zero moments into a mid-training state
        grads = _grads(walk, 1000 * step)
        tadam8.adam8_update_leaves_ref(list(zip(walk, grads, states)), 1e-2,
                                       step, **KW)
        for p, g, st in zip(stacked, grads, per_leaf):
            tadam8.adam8_update_ref(p, _stack(g), st, 1e-2, step, **KW)
    for leaf, p, st, ref in zip(walk, stacked, states, per_leaf):
        assert torch.equal(_stack(leaf), p)
        for name in ("mq", "ms", "vq", "vs"):
            assert torch.equal(getattr(st, name), getattr(ref, name)), name
    # the moments are live, and the ragged tail of a last row stays zero
    assert int(states[1].mq.abs().max()) > 0
    n = 5 * (2048 + 200)
    assert int(states[1].mq.reshape(-1)[n:].abs().max()) == 0


def test_wrapper_on_cpu_is_the_table_walk():
    opt = tadam8.adamw8bit(1e-3, min_8bit_size=MIN8)
    a, b = _leaves(7), _leaves(7)
    sa, sb = _states(a, opt), _states(b, opt)
    grads = _grads(a, 77)
    _kernels.reset_launch_counts()
    tadam8.adam8_update_leaves(list(zip(a, grads, sa)), 1e-3, 1, **KW)
    tadam8.adam8_update_leaves_ref(list(zip(b, grads, sb)), 1e-3, 1, **KW)
    assert set(_kernels.launches.values()) == {0}
    for la, lb in zip(a, b):
        for x, y in zip(la, lb):
            assert torch.equal(x, y)
    tadam8.adam8_update_leaves([], 1e-3, 1, **KW)  # no leaf, nothing to do


def test_update_steps_the_8bit_leaves_in_place_in_one_call(monkeypatch):
    """``AdamW8bit.update`` hands every 8-bit leaf, as its own part tensors
    (no stacked copy), to one ``adam8_update_leaves`` call; a leaf below
    ``min_8bit_size`` keeps fp32 moments and stays out of it."""
    opt = tadam8.adamw8bit(1e-3, weight_decay=KW["wd"], min_8bit_size=MIN8)
    leaves = _leaves(3) + [[_t(90, 100), _t(91, 100)]]  # 200 < MIN8
    state = opt.init(leaves)
    assert isinstance(state.per_leaf[-1], tadam8.FP32Moments)
    calls = []
    real = tadam8.adam8_update_leaves

    def record(eight, lr, step, **kw):
        calls.append([(parts, grads, st) for parts, grads, st in eight])
        return real(eight, lr, step, **kw)

    monkeypatch.setattr(tadam8, "adam8_update_leaves", record)
    small_before = [p.clone() for p in leaves[-1]]
    for step in range(2):
        opt.update(_grads(leaves, 500 + step), state, leaves)
    assert len(calls) == 2 and state.count == 2
    for eight in calls:
        assert len(eight) == len(LEAVES)
        for (parts, _, st), leaf, want in zip(eight, leaves,
                                              state.per_leaf):
            assert all(a is b for a, b in zip(parts, leaf))
            assert st is want
    assert not any(torch.equal(a, b) for a, b in zip(leaves[-1],
                                                     small_before))


def test_leaf_table_words():
    opt = tadam8.adamw8bit(1e-3, min_8bit_size=MIN8)
    leaves = _leaves(5)
    grads = _grads(leaves, 55)
    states = _states(leaves, opt)
    words, rows = tadam8.leaf_table(list(zip(leaves, grads, states)))
    nleaves = len(leaves)
    recs = words[:8 * nleaves].reshape(nleaves, 8)
    parts = words[8 * nleaves:].reshape(-1, 2)
    ns = [sum(p.numel() for p in leaf) for leaf in leaves]
    want_rows = [-(-n // tadam8.BLOCK) for n in ns]
    assert rows == sum(want_rows) and len(parts) == sum(map(len, leaves))
    assert list(recs[:, 0]) == list(np.cumsum([0] + want_rows[:-1]))
    assert list(recs[:, 1]) == ns
    assert list(recs[:, 2]) == [leaf[0].numel() for leaf in leaves]
    assert list(recs[:, 3]) == list(np.cumsum([0] + [len(x) for x in
                                                     leaves[:-1]]))
    for rec, st in zip(recs, states):
        assert list(rec[4:]) == [st.mq.data_ptr(), st.ms.data_ptr(),
                                 st.vq.data_ptr(), st.vs.data_ptr()]
    flat = [(p, g) for leaf, gl in zip(leaves, grads)
            for p, g in zip(leaf, gl)]
    assert [tuple(x) for x in parts] == [(p.data_ptr(), g.data_ptr())
                                         for p, g in flat]


@pytest.mark.parametrize("fault", ["misaligned part", "misaligned grad",
                                   "grad dtype", "moment shape",
                                   "part shapes", "grad parts"])
def test_leaf_table_refuses_what_the_kernel_does_not_take(fault):
    opt = tadam8.adamw8bit(1e-3, min_8bit_size=MIN8)
    parts = [_t(1, 3072), _t(2, 3072)]
    grads = [_t(3, 3072), _t(4, 3072)]
    st = opt.leaf_init(parts)
    if fault == "misaligned part":  # 4 bytes past a 16-byte boundary
        parts[1] = _t(5, 3073)[1:]
    elif fault == "misaligned grad":
        grads[0] = _t(6, 3073)[1:]
    elif fault == "grad dtype":
        grads[1] = grads[1].double()
    elif fault == "moment shape":
        st.mq = st.mq[:-1]
    elif fault == "part shapes":
        parts[1] = _t(7, 3, 1024)
    else:
        grads = grads[:1]
    with pytest.raises(ValueError, match="adam8"):
        tadam8.leaf_table([(parts, grads, st)])


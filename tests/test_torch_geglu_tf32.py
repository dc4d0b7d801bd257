"""The fp32 fused GEGLU feed-forward on 3xTF32 ``wgmma``
(``csrc/geglu_ff_tf32_sm90.cu``), held on the CPU: which kernel a call
takes (``geglu_ff.route``), a plain-PyTorch emulation of the kernel's
arithmetic (the LayerNorm-ed tile in fp32, each warpgroup's partial
up-projection over its 160 columns of the padded row with W1^T's k order
sigma, the partials summed in the kernel's order, the GEGLU, the
down-projection through W2^T's permuted hidden order, every product as
three tf32 products of hi and lo parts) against the JAX package's Pallas
kernel (interpret mode, as the JAX package's own tests run it) in fp32 on
the same numpy inputs, the pre-pass's index formulas and scratch size, the
shared-memory budget, and what the wrapper hands its launcher.  The kernel
itself meets the plain version on the card in
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdbc_tpu.ops import geglu_ff as jgeglu
from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.ops import geglu_ff as tgeglu
from tests.torch_threads import one_thread  # noqa: F401

# The emulation against the JAX kernel's fp32: 1e-4 of the largest output
# entry plus 1e-6 (the split products lose ~2^-21 of |a|.|b|, the sums run
# in other orders, and the JAX kernel's erf is a polynomial within 1.5e-7).
REL_TOL, ABS_TOL = 1e-4, 1e-6
WC, HC = 160, 16  # columns of a warpgroup, hidden columns of a chunk


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(rows, c, seed):
    rng = np.random.default_rng(seed)
    return (_rand(rng, rows, c), 1.0 + _rand(rng, c, scale=0.2),
            _rand(rng, c, scale=0.1), _rand(rng, c, 8 * c, scale=c ** -0.5),
            _rand(rng, 8 * c, scale=0.05),
            _rand(rng, 4 * c, c, scale=(4 * c) ** -0.5),
            _rand(rng, c, scale=0.05))


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


def sigma(p):
    """The k that W1^T's position p of a 32-column block holds: p = 8 kk +
    t + 4 h (k8 step kk, A-fragment column t + 4 h) holds 8 t + 2 kk + h,
    the column that thread t loads for it."""
    kk, t, h = p // 8, p % 4, (p % 8) // 4
    return 8 * t + 2 * kk + h


def pi(p):
    """The hidden column that W2^T's position p of a group of 8 holds."""
    return (p % 4) * 2 + p // 4


def cluster(c):
    return 1 if c <= 2 * WC else 2


def geglu_3xtf32(y, gamma, beta, w1, b1, w2, b2, eps=1e-5):
    """The kernel's arithmetic over (rows, c) fp32: the row padded to
    320 CL columns, warpgroup w of CTA r owning columns [320 r + 160 w, ...
    + 160) of the up-projection's k and of the output."""
    rows, c = y.shape
    cl = cluster(c)
    cp = 2 * WC * cl
    mu = y.sum(1, keepdim=True) / c
    var = ((y - mu) ** 2).sum(1, keepdim=True) / c
    xn = ((y - mu) * torch.rsqrt(var + eps)) * gamma + beta
    xn = torch.nn.functional.pad(xn, (0, cp - c))
    # W1^T (8c, cp) in the k order sigma, W2^T (c, 4c) in the order pi
    perm_k = [32 * (p // 32) + sigma(p % 32) for p in range(cp)]
    w1t = torch.nn.functional.pad(w1.t(), (0, cp - c))[:, perm_k]
    perm_h = [8 * (p // 8) + pi(p % 8) for p in range(4 * c)]
    w2t = w2.t()[:, perm_h]
    inner = 4 * c
    acc = torch.zeros(rows, c)
    for j in range(inner // HC):
        cols = list(range(j * HC, (j + 1) * HC))
        w1j = w1t[cols + [inner + i for i in cols]]  # [val | gate] rows
        parts = []
        for base in range(0, cp, WC):
            ks = list(range(base, base + WC))
            parts.append(mm3(xn[:, [perm_k[k] for k in ks]],
                             w1j[:, ks].t()))
        h = parts[0] + parts[1]
        if cl == 2:
            h = h + (parts[2] + parts[3])
        h = h + b1[cols + [inner + i for i in cols]]
        val, gate = h[:, :HC], h[:, HC:]
        a = val * (0.5 * gate * (1.0 + torch.erf(gate * 0.7071067811865476)))
        pos = list(range(j * HC, (j + 1) * HC))
        a_perm = a[:, [perm_h[p] - j * HC for p in pos]]
        acc = acc + mm3(a_perm, w2t[:, pos].t())
    return y + (acc + b2)


def _jax(args):
    return np.asarray(jgeglu._geglu_ff_rows(*(jnp.asarray(a) for a in args),
                                            1e-5))


# (rows, c): a narrow width (warpgroup 1's columns past c: a zero
# partial), SD-1.5's 64² width, a width past 320 (a cluster of two CTAs,
# four partials)
@pytest.mark.parametrize("rows,c", [(64, 64), (64, 320), (64, 384)])
def test_emulation_matches_jax(rows, c):
    args = _inputs(rows, c, seed=c)
    want = _jax(args)
    got = geglu_3xtf32(*(_t(a) for a in args)).numpy()
    assert np.abs(got - want).max() \
        <= REL_TOL * np.abs(want).max() + ABS_TOL


def test_emulation_matches_the_plain_version():
    """The plain fp32 version the card holds the kernel to
    (``geglu_ff_ref``) agrees with the emulation as closely."""
    args = [_t(a) for a in _inputs(96, 96, seed=7)]
    want = tgeglu.geglu_ff_ref(*args)
    got = geglu_3xtf32(*args)
    assert (got - want).abs().max() \
        <= REL_TOL * want.abs().max() + ABS_TOL


# ---------------------------------------------------------------------------
# the index algebra of the fragments and the pre-pass


def test_sigma_gives_each_thread_eight_contiguous_columns():
    """sigma is a permutation of a 32-column block, and thread t's A
    fragments of the block's four k8 steps (columns t and t + 4 of each)
    are the tile's columns 8 t .. 8 t + 7: two 16-byte loads a row, the
    k8 step kk's pair at offsets 2 kk and 2 kk + 1."""
    assert sorted(sigma(p) for p in range(32)) == list(range(32))
    for t in range(4):
        cols = [sigma(8 * kk + t + 4 * h) for kk in range(4)
                for h in range(2)]
        assert cols == list(range(8 * t, 8 * t + 8))


def test_sigma_products_equal_the_natural_product():
    """Reading A at sigma's columns against W1^T stored in sigma's order
    gives Xn . W1."""
    rng = np.random.default_rng(3)
    x, w = rng.standard_normal((16, 64)), rng.standard_normal((64, 24))
    perm = [32 * (p // 32) + sigma(p % 32) for p in range(64)]
    np.testing.assert_allclose(x[:, perm] @ w[perm], x @ w, atol=1e-12)


def test_permuted_w2t_carries_a_from_the_accumulator():
    """One warp's 16 rows and one k8 step of the down-projection: lane
    (g, t) holds a[g, 2t], a[g, 2t+1], a[g+8, 2t], a[g+8, 2t+1] (the
    up-projection's accumulator) and passes them as a0, a2, a1, a3, which
    the tf32 A fragment reads as (g, t), (g, t+4), (g+8, t), (g+8, t+4);
    with W2^T's hidden order pi the product is a.W2."""
    rng = np.random.default_rng(4)
    a, w2 = rng.standard_normal((16, 8)), rng.standard_normal((8, 24))
    frag = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        h = [a[g, 2 * t], a[g, 2 * t + 1], a[g + 8, 2 * t],
             a[g + 8, 2 * t + 1]]
        frag[g, t], frag[g + 8, t], frag[g, t + 4], frag[g + 8, t + 4] = (
            h[0], h[2], h[1], h[3])
    np.testing.assert_allclose(frag @ w2[[pi(p) for p in range(8)]], a @ w2,
                               atol=1e-12)


def test_pre_pass_formulas():
    """split_ff_kernel's source rows: W1^T position p of a 32-block from
    W1 row 8 (p % 4) + 2 (p / 8) + (p % 8) / 4, W2^T position p from W2 row
    (p & ~7) | ((p & 3) * 2 + ((p >> 2) & 1)); tiles (8c/32)(c/32) +
    (4c/32)(c/32); the scratch W1^T and W2^T as hi and lo parts."""
    assert [8 * (p % 4) + 2 * (p // 8) + (p % 8) // 4 for p in range(32)] \
        == [sigma(p) for p in range(32)]
    assert [(p & ~7) | ((p & 3) * 2 + ((p >> 2) & 1)) for p in range(32)] \
        == [8 * (p // 8) + pi(p % 8) for p in range(32)]
    for c in (32, 320, 640):
        assert tgeglu.scratch_floats(c) == 2 * (8 * c * c + 4 * c * c)


def test_warpgroups_cover_the_row_once():
    """Warpgroup w of CTA r owns [320 r + 160 w, ... + 160); its k slabs
    and output columns inside c: every column of c in exactly one, none
    past c loaded (slabs of 32)."""
    for c in (32, 64, 96, 320, 384, 576, 640):
        cl = cluster(c)
        owned = []
        for base in [320 * r + WC * w for r in range(cl) for w in range(2)]:
            nsl = min(max((c - base + 31) // 32, 0), WC // 32)
            owned += [k for k in range(base, base + 32 * nsl) if k < c]
            assert nsl == 0 or base + 32 * (nsl - 1) < c
        assert sorted(owned) == list(range(c))


@pytest.mark.parametrize("cl,ns1", [(1, 4), (2, 2)])
def test_shared_memory_budget(cl, ns1):
    """The fp32 tile (64 x 320), two exchange buffers of 2 CL partials
    (64 x 32 fp32), each warpgroup's W2^T buffer (160 x 16, hi and lo) and
    ring of NS1 W1^T slabs (32 x 32, hi and lo), 256 bytes of barriers and
    1024 of alignment room fit the H100's 232,448 bytes; one more slab a
    warpgroup would not."""
    fixed = 64 * 320 * 4 + 2 * 2 * cl * 64 * 32 * 4 + 2 * 2 * 160 * 16 * 4
    slab = 2 * 32 * 32 * 4
    smem = fixed + 2 * ns1 * slab + 256 + 1024
    assert smem <= 232448 < smem + 2 * slab


# ---------------------------------------------------------------------------
# the route and the wrapper (its launchers recorded)

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,c,want", [
    (F32, 320, "geglu_ff_tf32"), (F32, 640, "geglu_ff_tf32"),
    (F32, 96, "geglu_ff_tf32"), (F32, 32, "geglu_ff_tf32"),
    (F32, 48, "geglu_ff_simt"), (F32, 352, "geglu_ff_simt"),
    (F32, 704, "geglu_ff_simt"), (BF, 320, "geglu_ff"), (BF, 48,
                                                         "geglu_ff_simt")])
def test_route_by_dtype_and_width(dtype, c, want):
    assert tgeglu.route(dtype, c) == want


def _args(rows, c, dtype=torch.float32):
    z = lambda *sh, dt=dtype: torch.zeros(sh, dtype=dt)
    return [z(rows, c), z(c, dt=torch.float32), z(c, dt=torch.float32),
            z(c, 8 * c), z(8 * c), z(4 * c, c), z(c)]


@pytest.fixture
def recorded(monkeypatch):
    """CUDA rows "present" to ``geglu_ff_rows`` (its device check
    stubbed), the input check and every FF launcher of ``_kernels``
    replaced by recorders."""
    calls = []
    monkeypatch.setattr(tgeglu, "_on_cpu", lambda y: False)
    monkeypatch.setattr(tgeglu, "_check_cuda_inputs",
                        lambda *a, kernel: calls.append(("check", kernel)))
    for name in ("geglu_ff", "geglu_ff_tf32", "geglu_ff_simt"):
        monkeypatch.setattr(_kernels, name,
                            lambda *a, name=name: calls.append((name, a)))
    return calls


@pytest.mark.parametrize("c,want", [(320, "geglu_ff_tf32"),
                                    (640, "geglu_ff_tf32"),
                                    (48, "geglu_ff_simt")])
def test_wrapper_launches_the_kernel_route_names(recorded, c, want):
    args = _args(70, c)
    tgeglu.geglu_ff_rows(*args)
    assert [n for n, _ in recorded] == ["check", ("check", want)[0], want][1:]
    assert recorded[0] == ("check", want)
    handed = recorded[1][1]
    assert all(x is y for x, y in zip(handed, args))
    if want == "geglu_ff_tf32":
        out, scratch, eps = handed[7:]
        assert out.shape == args[0].shape and out.dtype == torch.float32
        assert scratch.dtype == torch.float32 \
            and scratch.numel() == 24 * c * c and eps == 1e-5


def test_tf32_input_check():
    """The 3xTF32 kernel's check takes fp32 rows at its widths, contiguous,
    the weights fp32; it refuses bf16 rows, odd widths and weights of
    another dtype."""
    tgeglu._check_cuda_inputs(*_args(64, 320), kernel="geglu_ff_tf32")
    for args, match in ((_args(64, 320, torch.bfloat16), "3xTF32 kernel"),
                        (_args(64, 48), "3xTF32 kernel")):
        with pytest.raises(ValueError, match=match):
            tgeglu._check_cuda_inputs(*args, kernel="geglu_ff_tf32")
    args = _args(64, 320)
    args[3] = args[3].bfloat16()
    with pytest.raises(ValueError, match="w1"):
        tgeglu._check_cuda_inputs(*args, kernel="geglu_ff_tf32")
    args = _args(64, 320)
    args[0] = torch.zeros(320, 64).t()
    with pytest.raises(ValueError, match="contiguous"):
        tgeglu._check_cuda_inputs(*args, kernel="geglu_ff_tf32")

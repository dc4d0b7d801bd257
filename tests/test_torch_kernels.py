"""sdbc_tpu_torch's CUDA kernels against their plain PyTorch versions.

Tests marked ``gpu`` need a CUDA device of capability 9.0 and skip
elsewhere; this file imports no JAX, so it also runs where only the port is
installed (on the card: ``python -m pytest tests/test_torch_kernels.py -m gpu
--noconftest``).  The rest checks the build and launch plumbing on the CPU.
"""
import numpy as np
import pytest
import torch

from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.ops import flash_attention as tflash
from sdbc_tpu_torch.ops import attention as tattn
from sdbc_tpu_torch.ops import flash_attention_bwd as tbwd
from sdbc_tpu_torch.ops import flash_attention_tt as ttt
from sdbc_tpu_torch.ops import flash_simt as tsimt
from sdbc_tpu_torch.ops import flash_tf32 as ttf32
from sdbc_tpu_torch.ops import geglu_ff as tgeglu
from sdbc_tpu_torch.ops import pallas_groupnorm as tpgn
from sdbc_tpu_torch.train import adam8bit as tadam8
from sdbc_tpu_torch.utils.dtypes import set_fp32_matmul_exact


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _attn_close(out, ref):
    """Attention outputs and gradients, bf16 kernel vs fp32 plain version:
    within 2% of the plain result's largest entry plus 1e-3 (bf16 rounding
    of q, p, o and of the backward's ds0 / p summed over the sequence).  An
    absolute bound would not do: over 4096 unit-normal keys the outputs are
    of size ~0.03, and one 64-key tile dropped moves them by ~1e-2."""
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    return err <= 2e-2 * ref.abs().max().item() + 1e-3


def _geglu_inputs(rows, c, seed=30):
    return (_rand(seed, rows, c), _rand(seed + 1, c) * 0.2 + 1.0,
            _rand(seed + 2, c) * 0.1, _rand(seed + 3, c, 8 * c, scale=c ** -0.5),
            _rand(seed + 4, 8 * c) * 0.05,
            _rand(seed + 5, 4 * c, c, scale=(4 * c) ** -0.5),
            _rand(seed + 6, c) * 0.05)


# ---------------------------------------------------------------------------
# build and launch plumbing (CPU)


def test_library_name_tracks_the_sources(monkeypatch, tmp_path):
    a = _kernels.library_path()
    assert a.name.startswith("libsdbc_kernels-") and a.suffix == ".so"
    assert _kernels.library_path() == a  # stable for unchanged sources
    src = tmp_path / "csrc"
    src.mkdir()
    for f in _kernels._sources():
        (src / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_kernels, "CSRC", src)
    assert _kernels.library_path() == a
    (src / "flash_fwd_sm90.cu").write_text("// edited\n")
    assert _kernels.library_path() != a


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()


def test_launch_counts_reset():
    _kernels.launches["flash_fixed"] += 3
    _kernels.reset_launch_counts()
    assert set(_kernels.launches.values()) == {0}


# ---------------------------------------------------------------------------
# the kernels on the card


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA device of capability 9.0 (the kernels are "
                    "built for sm_90a)")
    set_fp32_matmul_exact()  # the fp32 plain versions without TF32
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("layout,qshape,sk", [
    ("bshd", (2, 256, 4, 40), 256), ("bshd", (2, 200, 4, 40), 300),
    ("bshd", (1, 128, 2, 8), 256), ("bshd", (1, 64, 2, 160), 256),
    ("bshd", (1, 100, 2, 256), 77), ("bshd", (2, 4096, 8, 40), 4096),
    ("bhsd", (1, 2, 256, 40), 256), ("bhsd", (2, 1, 128, 80), 300),
    # the wgmma kernel's edges: each main-path head dim at key counts that
    # are no multiple of its 64- or 128-key tile, in both layouts; a q tile
    # of 100 rows (less than one 128-row block); D = 8 and 256
    ("bshd", (1, 333, 2, 80), 333), ("bshd", (1, 300, 2, 160), 300),
    ("bhsd", (1, 2, 300, 40), 300), ("bhsd", (1, 2, 333, 80), 333),
    ("bhsd", (1, 2, 200, 160), 200), ("bshd", (1, 100, 2, 80), 130),
    ("bhsd", (1, 2, 100, 8), 100), ("bhsd", (1, 2, 100, 256), 200),
    # SD-2.x / SDXL's head dim 64 at the 832×1216 portrait's ragged token
    # counts (26×38 and 52×76) and at a ragged key count
    ("bshd", (1, 988, 4, 64), 988), ("bshd", (1, 3952, 2, 64), 3952),
    ("bhsd", (1, 2, 333, 64), 200)])
def test_flash_kernel_matches_plain_on_card(hopper, layout, qshape, sk):
    kshape = list(qshape)
    kshape[1 if layout == "bshd" else 2] = sk
    q, k, v = (torch.from_numpy(_rand(s, *sh)).to(hopper, torch.bfloat16)
               for s, sh in ((50, qshape), (51, kshape), (52, kshape)))
    before = _kernels.launches["flash_fixed"]
    tr = lambda t: t.transpose(1, 2)
    if layout == "bshd":
        out = tflash.flash_attention_fixed_bshd(q, k, v)
        ref = tr(tflash.fixed_cap_attention_ref(tr(q).float(), tr(k).float(),
                                                tr(v).float()))
    else:
        out = tflash.flash_attention_fixed(q, k, v)
        ref = tflash.fixed_cap_attention_ref(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert _kernels.launches["flash_fixed"] == before + 1
    assert _attn_close(out, ref)


def _aligned(seed, b, h, sq, sk, d, q_scale, k_scale, c, late):
    """Head-major q, k, v where q and the keys ``late``.. share a direction
    with weight ``c``: large logits at the end of the key sequence."""
    u = _rand(seed, d)
    u /= np.linalg.norm(u)
    q = _rand(seed + 1, b, h, sq, d, scale=q_scale) + c * u
    k = _rand(seed + 2, b, h, sk, d, scale=k_scale)
    k[:, :, late:] += c * u
    return q, k, _rand(seed + 3, b, h, sk, d)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_kernel_near_the_cap_on_card(hopper, layout):
    """Natural logits up to ~40 (the cap is 60/log2e ≈ 41.6): p reaches
    2^57, and the fp32 sums must not lose the smaller terms."""
    d = 40
    q, k, v = _aligned(80, 1, 2, 200, 300, d, 0.2, 0.2,
                       np.sqrt(36.0 * np.sqrt(d)), 250)
    q, k, v = (torch.from_numpy(a).to(hopper, torch.bfloat16)
               for a in (q, k, v))
    ref = tflash.fixed_cap_attention_ref(q.float(), k.float(), v.float())
    if layout == "bshd":
        tr = lambda t: t.transpose(1, 2).contiguous()
        out = tflash.flash_attention_fixed_bshd(tr(q), tr(k),
                                                tr(v)).transpose(1, 2)
    else:
        out = tflash.flash_attention_fixed(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert _attn_close(out, ref)


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take(hopper):
    """The tensor-core kernel's check refuses fp32 and a head dim that is
    no multiple of 8; the entry point hands fp32 to the 3xTF32 kernel and
    the odd head dim to the CUDA-core kernel; fp16 and head dims above 512
    no kernel takes."""
    for dt, d, name in ((torch.float32, 40, "flash_fixed_tf32"),
                        (torch.bfloat16, 44, "flash_fixed_simt")):
        q = torch.zeros(1, 256, 2, d, device=hopper, dtype=dt)
        with pytest.raises(ValueError, match="takes bfloat16"):
            tflash._launch(q, q, q, torch.empty_like(q), 1.0)
        before = dict(_kernels.launches)
        tflash.flash_attention_fixed_bshd(q, q, q)
        assert _kernels.launches[name] == before[name] + 1
        assert _kernels.launches["flash_fixed"] == before["flash_fixed"]
    for dt, d in ((torch.float16, 40), (torch.bfloat16, 520)):
        q = torch.zeros(1, 256, 2, d, device=hopper, dtype=dt)
        with pytest.raises((TypeError, ValueError), match="flash_simt"):
            tflash.flash_attention_fixed_bshd(q, q, q)


@pytest.mark.gpu
# SD-1.5's 64² and 32² levels at sampling batch 8; c not a multiple of 64
# (the kernel pads to 64 columns); rows no 128- or 64-row tile divides
@pytest.mark.parametrize("rows,c", [(256, 32), (200, 64), (512, 320),
                                    (100, 384), (256, 640), (8192, 640),
                                    (32768, 320), (200, 96), (333, 288),
                                    (300, 320), (1000, 640), (77, 448),
                                    (130, 576)])
def test_geglu_kernel_matches_plain_on_card(hopper, rows, c):
    args = [torch.from_numpy(a).to(hopper) for a in _geglu_inputs(rows, c)]
    for i in (0, 3, 4, 5, 6):
        args[i] = args[i].bfloat16()
    before = _kernels.launches["geglu_ff"]
    out = tgeglu.geglu_ff_rows(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["geglu_ff"] == before + 1
    ref = tgeglu.geglu_ff_ref(*(a.float() for a in args))
    # bf16 rounding of the LN tile, hidden and output (|o| up to ~8)
    assert (out.float() - ref).abs().max().item() < 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize("rows,c", [(256, 320), (200, 640), (96, 64)])
def test_geglu_kernel_large_gates_on_card(hopper, rows, c):
    """Gates spread over ±30 (W1's gate columns ×8, b1's gate half ±4):
    GELU through both erf tails (0 and the identity); val kept small (×0.1)
    so the output stays where 5e-2 is a few bf16 ulps."""
    y, gamma, beta, w1, b1, w2, b2 = _geglu_inputs(rows, c, seed=60)
    inner = 4 * c
    w1 = w1.copy()
    w1[:, :inner] *= 0.1
    w1[:, inner:] *= 8.0
    b1 = b1.copy()
    b1[inner:] = _rand(67, inner) * 4.0
    args = [torch.from_numpy(a).to(hopper)
            for a in (y, gamma, beta, w1, b1, w2, b2)]
    for i in (0, 3, 4, 5, 6):
        args[i] = args[i].bfloat16()
    out = tgeglu.geglu_ff_rows(*args)
    torch.cuda.synchronize()
    ref = tgeglu.geglu_ff_ref(*(a.float() for a in args))
    # the gates the kernel saw do reach both tails
    xn = torch.nn.functional.layer_norm(args[0].float(), (c,), args[1],
                                        args[2], 1e-5)
    gate = xn @ args[3].float()[:, inner:] + args[4].float()[inner:]
    assert gate.min().item() < -10 and gate.max().item() > 10
    assert (out.float() - ref).abs().max().item() < 5e-2


@pytest.mark.gpu
def test_geglu_kernel_refuses_what_it_does_not_take(hopper):
    """c = 48 is no multiple of 32: the tensor-core kernel's check refuses
    it and the entry point takes the CUDA-core kernel; fp16 rows no kernel
    takes."""
    args = [torch.from_numpy(a).to(hopper) for a in _geglu_inputs(64, 48)]
    for i in (0, 3, 4, 5, 6):
        args[i] = args[i].bfloat16()
    with pytest.raises(ValueError, match="tensor-core kernel takes"):
        tgeglu._check_cuda_inputs(*args)
    before = dict(_kernels.launches)
    tgeglu.geglu_ff_rows(*args)
    assert _kernels.launches["geglu_ff_simt"] == before["geglu_ff_simt"] + 1
    assert _kernels.launches["geglu_ff"] == before["geglu_ff"]
    for i in (0, 3, 4, 5, 6):
        args[i] = args[i].half()
    with pytest.raises(ValueError, match="CUDA-core kernel takes"):
        tgeglu.geglu_ff_rows(*args)


def _fp32_close(out, ref):
    """A CUDA-core kernel in fp32 against its fp32 plain version: the two
    sum in other orders (and exp2 and erf differ by an ulp or two)."""
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    return err <= 1e-5 * ref.abs().max().item() + 1e-6


def _simt_close(out, ref, dtype):
    return _fp32_close(out, ref) if dtype == torch.float32 \
        else _attn_close(out, ref)


@pytest.mark.gpu
# fp32 at the tiny UNet's and VAE's heads and a main-path head; bf16 where
# the tensor-core kernels do not take it: the VAE's 512 head (fixed cap),
# head dims no multiple of 8; ragged sequences
@pytest.mark.parametrize("dtype,qshape,sk", [
    ("float32", (2, 4, 256, 8), 256), ("float32", (1, 2, 300, 40), 333),
    ("float32", (1, 1, 256, 64), 256), ("float32", (1, 1, 200, 512), 130),
    ("bfloat16", (1, 1, 256, 512), 256), ("bfloat16", (1, 2, 200, 44), 77),
    ("bfloat16", (2, 2, 100, 204), 300)])
def test_flash_simt_matches_plain_on_card(hopper, dtype, qshape, sk):
    """The CUDA-core kernels (csrc/flash_simt.cu) against the plain
    versions of their functions: the fixed cap (head-major and through the
    projection layout's strides, the same bits), the training forward (out
    and LSE) and the backward's dq, dk, dv; each call counted.  All
    through ``flash_simt``'s wrappers (the entry points send fp32 at head
    dims that are a multiple of 8 up to 256, and the backward up to 160,
    to the 3xTF32 kernels: ``test_flash_tf32_matches_plain_on_card``,
    ``test_flash_bwd_tf32_matches_plain_on_card``)."""
    dt = getattr(torch, dtype)
    b, h, sq, d = qshape
    q, k, v = _bshd_views(hopper, qshape, sk, 190)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    do = torch.from_numpy(_rand(195, b, h, sq, d)).to(hopper, dt)
    scale = d ** -0.5
    _kernels.reset_launch_counts()
    fixed = tsimt.fixed_cap(q, k, v, torch.empty(q.shape, device=hopper,
                                                 dtype=dt), scale)
    tr = lambda t: t.transpose(1, 2)
    fixed_bshd = tr(torch.empty(b, sq, h, d, device=hopper, dtype=dt))
    tsimt.fixed_cap(q, k, v, fixed_bshd, scale)
    out, lse = tsimt.fwd(q, k, v, scale)
    grads = tsimt.bwd(*tbwd.prepare(q, k, out, do, lse, scale)[:2], v, do,
                      *tbwd.prepare_vectors(out, do, lse), scale)
    torch.cuda.synchronize()
    assert {n: c for n, c in _kernels.launches.items() if c} \
        == {"flash_fixed_simt": 2, "flash_fwd_simt": 1,
            "flash_bwd_simt_dq": 1, "flash_bwd_simt_dkv": 1}
    ref = tflash.fixed_cap_attention_ref(q, k, v)
    assert _simt_close(fixed, ref, dt)
    assert torch.equal(fixed, fixed_bshd)
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, scale)
    assert _simt_close(out, ref, dt)
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    for g, r in zip(grads, tbwd.flash_bwd_ref(q, k, v, out, do, lse, scale)):
        assert g.shape == r.shape and g.dtype == dt and _simt_close(g, r, dt)


def _tf32_close(out, ref):
    """The 3xTF32 forward in fp32 against its fp32 plain version: its split
    products lose ~2^-21 of each score, which over 4096 keys moves the
    outputs by up to ~3e-5 of their largest entry; 1e-4 of it plus 1e-6."""
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    return err <= 1e-4 * ref.abs().max().item() + 1e-6


def _bshd_f32(hopper, qshape, sk, seed):
    """fp32 (B, H, S, D) views over (B, S, H, D) memory (values that use
    every mantissa bit, so the split's lo parts are not zero)."""
    b, h, sq, d = qshape
    return [torch.from_numpy(_rand(seed + i, b, s, h, d)).to(hopper)
            .transpose(1, 2) for i, s in enumerate((sq, sk, sk))]


@pytest.mark.gpu
# the tiny configs' head dims, the main path's (40, 80, 160) at ragged
# sequences, every instantiation's widest head, the 64² level
@pytest.mark.parametrize("qshape,sk", [
    ((2, 4, 256, 8), 256), ((1, 1, 256, 64), 256), ((1, 2, 300, 40), 333),
    ((1, 2, 200, 80), 300), ((1, 2, 256, 160), 77), ((1, 1, 100, 128), 150),
    ((1, 1, 100, 192), 150), ((1, 1, 130, 256), 200),
    ((2, 8, 4096, 40), 4096)])
def test_flash_tf32_matches_plain_on_card(hopper, qshape, sk):
    """The 3xTF32 forward (csrc/flash_fwd_tf32_sm90.cu) through the entry
    points: the fixed cap (head-major and through the projection layout's
    strides, the same bits) and the training forward (LSE within 1e-5)
    against the plain versions, one launch a call; the fp32 backward (the
    kernels ``flash_attention.route_bwd`` names: 3xTF32 up to head dim
    160, the CUDA-core ones above) on its output and LSE against the plain
    backward of the plain forward's."""
    b, h, sq, d = qshape
    q, k, v = _bshd_f32(hopper, qshape, sk, 700)
    do = torch.from_numpy(_rand(705, b, h, sq, d)).to(hopper)
    scale = d ** -0.5
    tr = lambda t: t.transpose(1, 2)
    _kernels.reset_launch_counts()
    fixed = tflash.flash_attention_fixed(q, k, v)
    fixed_bshd = tr(tflash.flash_attention_fixed_bshd(tr(q), tr(k), tr(v)))
    out, lse = tflash.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert {n: c for n, c in _kernels.launches.items() if c} \
        == {"flash_fixed_tf32": 2, "flash_fwd_tf32": 1}
    assert _tf32_close(fixed, tflash.fixed_cap_attention_ref(q, k, v))
    assert torch.equal(fixed, fixed_bshd)
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, scale)
    assert out.dtype == torch.float32 and _tf32_close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-5
    _kernels.reset_launch_counts()
    grads = tbwd.flash_bwd(q, k, v, out, do, lse, scale)
    torch.cuda.synchronize()
    assert {n: c for n, c in _kernels.launches.items() if c} \
        == dict.fromkeys(tflash.route_bwd(torch.float32, d), 1)
    for g, r in zip(grads, tbwd.flash_bwd_ref(q, k, v, ref, do, ref_lse,
                                               scale)):
        assert g.shape == r.shape and _tf32_close(g, r)


@pytest.mark.gpu
# every instantiation (NV 40, 80, 160) and the head dims padded up to one
# (8, 64, 128), ragged sequences no 16-, 32- or 64-row tile divides, fewer
# rows than one tile, the 64² level
@pytest.mark.parametrize("qshape,sk", [
    ((2, 4, 256, 8), 256), ((1, 2, 300, 40), 333), ((1, 2, 200, 80), 300),
    ((1, 2, 256, 160), 77), ((1, 1, 100, 64), 150), ((1, 1, 130, 128), 200),
    ((1, 2, 90, 160), 130), ((1, 2, 33, 40), 20), ((2, 8, 4096, 40), 4096)])
def test_flash_bwd_tf32_matches_plain_on_card(hopper, qshape, sk):
    """The 3xTF32 backward (csrc/flash_bwd_tf32_sm90.cu) through
    ``flash_bwd``, over head-major views of (B, S, H, D) memory: dq, dk, dv
    against the plain version of what the kernels compute from
    ``prepare``'s inputs, one launch of each kernel, the same bits from a
    second call (no atomics)."""
    b, h, sq, d = qshape
    q, k, v = _bshd_f32(hopper, qshape, sk, 720)
    do = torch.from_numpy(_rand(725, b, sq, h, d)).to(hopper).transpose(1, 2)
    scale = d ** -0.5
    o, lse = tflash.flash_attention_ref(q, k, v, scale)
    _kernels.reset_launch_counts()
    grads = tbwd.flash_bwd(q, k, v, o, do, lse, scale)
    torch.cuda.synchronize()
    assert {n: c for n, c in _kernels.launches.items() if c} \
        == {"flash_bwd_dq_tf32": 1, "flash_bwd_dkv_tf32": 1}
    refs = tbwd.flash_bwd_prepared_ref(*tbwd.prepare(q, k, o, do, lse, scale)
                                       [:2], v, do,
                                       *tbwd.prepare_vectors(o, do, lse),
                                       scale)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.shape == r.shape and g.dtype == torch.float32, name
        assert torch.isfinite(g).all() and _tf32_close(g, r), name
    again = tbwd.flash_bwd(q, k, v, o, do, lse, scale)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))


# Against an fp64 backward on far-negative inputs, the 3xTF32 backward's
# error may be at most this multiple of the fp32 plain backward's: each of
# the two chained products (the logits, then the gradient) keeps 2^-21 of
# |a|·|b| where an fp32 product keeps 2^-24 (8x each), and those inputs'
# logits reach |s| ~ 200 (log2 units), so the rounding of s itself sets the
# error of p (the test prints each ratio; PERF.md §6 records them).
TF32_FAR_NEGATIVE_FP64_FACTOR = 32.0


@pytest.mark.gpu
@pytest.mark.parametrize("all_rows", [False, True])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_flash_bwd_tf32_far_negative_lse_on_card(hopper, d, all_rows):
    """``test_flash_bwd_kernels_far_negative_lse_on_card`` and
    ``test_flash_bwd_far_negative_all_rows_against_fp64_on_card`` on the
    fp32 route: six q rows (or every row) whose every logit is far below 0
    (lse2 near -185); a zero-filled key past Sk = 300 would give
    p = exp2(-lse2) = inf in those rows, so only the dq kernel's mask of
    the last key tile keeps dq finite.  Held against the fp64 gradient,
    within ``TF32_FAR_NEGATIVE_FP64_FACTOR`` of the fp32 plain backward's
    error on the same inputs."""
    rows = [0, 37, 64, 101, 150, 199]
    scale = d ** -0.5
    u = _rand(98, d)
    u /= np.linalg.norm(u)
    b = 20.0
    if all_rows:
        q = _rand(103, 1, 2, 200, d, scale=0.1) - 150.0 / (b * scale) * u
    else:
        q = _rand(99, 1, 2, 200, d)
        q[:, :, rows] = _rand(103, 1, 2, len(rows), d, scale=0.1) \
            - 150.0 / (b * scale) * u
    k = _rand(100, 1, 2, 300, d) + b * u
    q, k, v, do = (torch.from_numpy(a).to(hopper)
                   for a in (q, k, _rand(101, 1, 2, 300, d),
                             _rand(102, 1, 2, 200, d)))
    o, lse = tflash.flash_attention_ref(q, k, v, scale)
    assert lse[..., rows].max().item() * tbwd.LOG2E < -128
    _kernels.reset_launch_counts()
    grads = tbwd.flash_bwd(q, k, v, o, do, lse, scale)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_bwd_dq_tf32"] == 1
    plain = tbwd.flash_bwd_ref(q, k, v, o, do, lse, scale)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    p64 = torch.softmax(scale * q64 @ k64.transpose(-1, -2), dim=-1)
    dp64 = do64 @ v64.transpose(-1, -2)
    delta64 = (do64 * (p64 @ v64)).sum(-1, keepdim=True)
    ds64 = p64 * (dp64 - delta64)
    exact = (scale * ds64 @ k64, scale * ds64.transpose(-1, -2) @ q64,
             p64.transpose(-1, -2) @ do64)
    for name, g, r, x in zip(("dq", "dk", "dv"), grads, plain, exact):
        assert torch.isfinite(g).all(), name
        err = (g.double() - x).abs().max().item()
        plain_err = (r.double() - x).abs().max().item()
        print(f"d={d} all_rows={all_rows} {name}: 3xTF32 err {err:.3e}, "
              f"fp32 plain err {plain_err:.3e} (ratio "
              f"{err / plain_err:.2f})")
        assert err <= TF32_FAR_NEGATIVE_FP64_FACTOR * plain_err, name


@pytest.mark.gpu
def test_flash_bwd_tf32_refuses_what_it_does_not_take_on_card(hopper):
    """The 3xTF32 backward's wrapper refuses bf16, head dims that are no
    multiple of 8 and head dims above 160, and its C entry a dq whose
    strides are odd, with no launch counted; ``flash_bwd`` sends fp32 at
    those head dims to the CUDA-core kernels."""
    from sdbc_tpu_torch.ops import flash_bwd_tf32 as tbt

    names = ("flash_bwd_dq_tf32", "flash_bwd_dkv_tf32")
    before = {n: _kernels.launches[n] for n in names}
    vec = torch.zeros(1, 2, 256, device=hopper)
    for dt, d in ((torch.bfloat16, 40), (torch.float32, 44),
                  (torch.float32, 168)):
        q = torch.zeros(1, 2, 256, d, device=hopper, dtype=dt)
        with pytest.raises(ValueError, match="flash_bwd_tf32"):
            tbt.bwd(q, q, q, q, vec, vec, 1.0)
    q = torch.zeros(1, 2, 256, 40, device=hopper)
    dq = torch.empty(1, 2, 256, 41, device=hopper)[..., :40]
    scratch = torch.empty(tbt.scratch_floats(1, 2, 256, 256, 40),
                          device=hopper)
    with pytest.raises(RuntimeError, match="flash_bwd_dq_tf32"):
        _kernels.flash_bwd_dq_tf32(q, q, q, q, vec, vec, dq, scratch, 1.0,
                                   1.0)
    assert {n: _kernels.launches[n] for n in names} == before
    for d in (44, 168):
        q = torch.zeros(1, 2, 64, d, device=hopper)
        _kernels.reset_launch_counts()
        tbwd.flash_bwd(q, q, q, q, q, torch.zeros(1, 2, 64, device=hopper),
                       1.0)
        assert _kernels.launches["flash_bwd_simt_dq"] == 1
        assert _kernels.launches["flash_bwd_dq_tf32"] == 0


@pytest.mark.gpu
def test_flash_tf32_refuses_what_it_does_not_take_on_card(hopper):
    """The 3xTF32 wrapper refuses bf16, head dims that are no multiple of
    8 and head dims above 512, and its C entry a q that TMA cannot read,
    with no launch counted; the entry points send fp32 at head dims that
    are no multiple of 8 to the CUDA-core kernels, fp32 at 264 to the wide
    3xTF32 kernel and bf16 to the bf16 kernels."""
    tf32 = ("flash_fixed_tf32", "flash_fwd_tf32")
    before = {n: _kernels.launches[n] for n in tf32}
    for dt, d in ((torch.bfloat16, 40), (torch.float32, 44),
                  (torch.float32, 520)):
        q = torch.zeros(1, 2, 256, d, device=hopper, dtype=dt)
        with pytest.raises(ValueError, match="flash_tf32"):
            ttf32.fixed_cap(q, q, q, torch.empty_like(q), 1.0)
        with pytest.raises(ValueError, match="flash_tf32"):
            ttf32.fwd(q, q, q, torch.empty_like(q),
                      torch.empty(1, 2, 256, device=hopper), 1.0)
    base = torch.zeros(1, 2, 256, 41, device=hopper)
    q = base[..., 1:]  # 4 bytes past a 16-byte boundary
    o = torch.empty(1, 2, 256, 40, device=hopper)
    scratch = torch.empty(4 * 2 * 256 * 40, device=hopper)
    with pytest.raises(RuntimeError, match="flash_fixed_tf32"):
        _kernels.flash_tf32(q, o, o, o, None, scratch, 1.0, fixed=True)
    assert {n: _kernels.launches[n] for n in tf32} == before
    for dt, d, names in ((torch.float32, 44, ("flash_fixed_simt",
                                              "flash_fwd_simt")),
                         (torch.float32, 264, ("flash_fixed_tf32",
                                               "flash_fwd_tf32")),
                         (torch.bfloat16, 40, ("flash_fixed", "flash_fwd"))):
        q = torch.zeros(1, 2, 256, d, device=hopper, dtype=dt)
        _kernels.reset_launch_counts()
        tflash.flash_attention_fixed(q, q, q)
        tflash.flash_fwd(q, q, q, 1.0)
        torch.cuda.synchronize()
        assert {n: c for n, c in _kernels.launches.items() if c} \
            == dict.fromkeys(names, 1)


@pytest.mark.gpu
# the VAE's 512-wide head, a ragged pair at the narrowest head the wide
# kernel takes (CTA 1 holds 8 columns), a head that leaves CTA 1 one piece
@pytest.mark.parametrize("qshape,sk", [
    ((1, 1, 4096, 512), 4096), ((1, 2, 200, 264), 300),
    ((2, 1, 130, 384), 77)])
def test_flash_tf32_wide_matches_plain_on_card(hopper, qshape, sk):
    """The wide 3xTF32 forward (csrc/flash_fwd_tf32_wide_sm90.cu) through
    the entry points: the fixed cap (head-major and through the projection
    layout's strides, the same bits) and the training forward (LSE within
    1e-5) against the plain versions, one launch a call, two calls the
    same bits; the fp32 transposed-layout forward on the same kernel."""
    b, h, sq, d = qshape
    q, k, v = _bshd_f32(hopper, qshape, sk, 800)
    scale = d ** -0.5
    tr = lambda t: t.transpose(1, 2)
    _kernels.reset_launch_counts()
    fixed = tflash.flash_attention_fixed(q, k, v)
    fixed_bshd = tr(tflash.flash_attention_fixed_bshd(tr(q), tr(k), tr(v)))
    out, lse = tflash.flash_fwd(q, k, v, scale)
    out_tt, lse_tt = ttt.flash_fwd_tt(q, k, v, scale)
    again, _ = tflash.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert {n: c for n, c in _kernels.launches.items() if c} \
        == {"flash_fixed_tf32": 2, "flash_fwd_tf32": 3}
    assert _tf32_close(fixed, tflash.fixed_cap_attention_ref(q, k, v))
    assert torch.equal(fixed, fixed_bshd)
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, scale)
    assert _tf32_close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= 1e-5
    assert torch.equal(out, again) and torch.equal(out, out_tt) \
        and torch.equal(lse, lse_tt)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [264, 512])
def test_flash_tf32_wide_far_negative_rows_on_card(hopper, d):
    """Six q rows whose every logit is far below 0 (|s| ~ 216 in log2
    units): the training forward's running max keeps them finite, and its
    output and LSE stay within ``TF32_FAR_NEGATIVE_FP64_FACTOR`` of the
    fp32 plain version's error from fp64 (3xTF32 keeps 2^-21 of a product
    where fp32 keeps 2^-24)."""
    rows = [0, 37, 64, 101, 150, 199]
    scale = d ** -0.5
    u = _rand(198, d)
    u /= np.linalg.norm(u)
    q = _rand(199, 1, 2, 200, d)
    q[:, :, rows] = _rand(203, 1, 2, len(rows), d, scale=0.1) \
        - 150.0 / (20.0 * scale) * u
    k = _rand(200, 1, 2, 300, d) + 20.0 * u
    q, k, v = (torch.from_numpy(a).to(hopper)
               for a in (q, k, _rand(201, 1, 2, 300, d)))
    _kernels.reset_launch_counts()
    out, lse = tflash.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_fwd_tf32"] == 1
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, scale)
    assert ref_lse[..., rows].max().item() * tbwd.LOG2E < -128
    s64 = scale * q.double() @ k.double().transpose(-1, -2)
    exact = torch.softmax(s64, dim=-1) @ v.double()
    exact_lse = torch.logsumexp(s64, dim=-1)
    for name, got, plain, x in (("out", out, ref, exact),
                                ("lse", lse, ref_lse, exact_lse)):
        assert torch.isfinite(got).all(), name
        err = (got.double() - x).abs().max().item()
        plain_err = (plain.double() - x).abs().max().item()
        print(f"d={d} {name}: 3xTF32 err {err:.3e}, fp32 plain err "
              f"{plain_err:.3e}")
        assert err <= TF32_FAR_NEGATIVE_FP64_FACTOR * plain_err, name


@pytest.mark.gpu
# SD-1.5's sampling rows at 64² and 32² (batch 8), a row count that no
# 64-row tile divides, a narrow width (warpgroup 1 idle), widths past 320
# (a cluster of two CTAs; at 384 CTA 1 holds 64 columns)
@pytest.mark.parametrize("rows,c", [
    (32768, 320), (8192, 640), (100, 320), (130, 96), (77, 384),
    (64, 32)])
def test_geglu_tf32_matches_plain_on_card(hopper, rows, c):
    """The 3xTF32 fused FF (csrc/geglu_ff_tf32_sm90.cu) through
    ``geglu_ff_rows``: fp32 rows against the plain version within 1e-4 of
    its largest entry plus 1e-6, one launch a call (the split pre-pass
    in), two calls the same bits."""
    args = [torch.from_numpy(a).to(hopper) for a in _geglu_inputs(rows, c)]
    _kernels.reset_launch_counts()
    out = tgeglu.geglu_ff_rows(*args)
    again = tgeglu.geglu_ff_rows(*args)
    torch.cuda.synchronize()
    assert {n: c_ for n, c_ in _kernels.launches.items() if c_} \
        == {"geglu_ff_tf32": 2}
    ref = tgeglu.geglu_ff_ref(*args)
    err = (out - ref).abs().max().item()
    assert torch.isfinite(out).all() \
        and err <= 1e-4 * ref.abs().max().item() + 1e-6
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_geglu_tf32_refuses_what_it_does_not_take_on_card(hopper):
    """The 3xTF32 FF's check refuses bf16 rows and widths that are no
    multiple of 32, and its C entry a width past 640 or a missing scratch,
    with no launch counted; ``geglu_ff_rows`` sends fp32 at c = 48 to the
    CUDA-core kernel."""
    args = [torch.from_numpy(a).to(hopper) for a in _geglu_inputs(64, 48)]
    with pytest.raises(ValueError, match="3xTF32 kernel takes"):
        tgeglu._check_cuda_inputs(*args, kernel="geglu_ff_tf32")
    _kernels.reset_launch_counts()
    tgeglu.geglu_ff_rows(*args)
    torch.cuda.synchronize()
    assert {n: c for n, c in _kernels.launches.items() if c} \
        == {"geglu_ff_simt": 1}
    args = [torch.from_numpy(a).to(hopper) for a in _geglu_inputs(64, 704)]
    out = torch.empty_like(args[0])
    with pytest.raises(RuntimeError, match="geglu_ff_tf32"):
        _kernels.geglu_ff_tf32(*args, out,
                               torch.empty(24 * 704 * 704, device=hopper),
                               1e-5)
    assert _kernels.launches["geglu_ff_tf32"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rows,c", [
    ("float32", 512, 32), ("float32", 200, 40), ("float32", 256, 320),
    ("float32", 77, 640), ("bfloat16", 100, 48), ("bfloat16", 64, 360)])
def test_geglu_simt_matches_plain_on_card(hopper, dtype, rows, c):
    """The CUDA-core fused FF (csrc/geglu_ff_simt.cu) against its plain
    version through its launcher: fp32 rows (the tiny UNet's c = 32 among
    them; the entry point sends fp32 at widths that are a multiple of 32
    to the 3xTF32 kernel) and bf16 widths the tensor-core kernel does not
    take."""
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(hopper) for a in _geglu_inputs(rows, c)]
    for i in (0, 3, 4, 5, 6):
        args[i] = args[i].to(dt)
    tgeglu._check_cuda_inputs(*args, kernel="geglu_ff_simt")
    before = _kernels.launches["geglu_ff_simt"]
    out = torch.empty_like(args[0])
    _kernels.geglu_ff_simt(*args, out, 1e-5)
    torch.cuda.synchronize()
    assert _kernels.launches["geglu_ff_simt"] == before + 1
    ref = tgeglu.geglu_ff_ref(*args)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= (1e-5 * ref.float().abs().max().item() + 1e-6
                   if dt == torch.float32 else 5e-2)


# the training kernels (csrc/flash_fwd_sm90.cu, csrc/flash_bwd_sm90.cu,
# csrc/flash_bwd_wide_sm90.cu, csrc/adam8bit.cu)

TRAIN_SHAPES = [((2, 8, 1024, 80), 1024), ((1, 2, 200, 40), 300),
                ((1, 2, 256, 160), 256), ((1, 2, 128, 8), 256),
                ((1, 2, 140, 40), 77), ((1, 1, 128, 256), 300)]


def _bshd_views(hopper, qshape, sk, seed):
    """bf16 (B, H, S, D) views over (B, S, H, D) memory, as the UNet's head
    split gives them to the kernels."""
    b, h, sq, d = qshape
    out = []
    for i, s in enumerate((sq, sk, sk)):
        t = torch.from_numpy(_rand(seed + i, b, s, h, d)).to(hopper,
                                                            torch.bfloat16)
        out.append(t.transpose(1, 2))
    return out


# the forward's own edges on the wgmma kernel: main-path head dims at key
# counts no 64- or 128-key tile divides, a 100-row q tile, D = 8 and 256
FWD_SHAPES = TRAIN_SHAPES + [((1, 2, 333, 80), 333), ((1, 2, 300, 160), 300),
                             ((1, 2, 100, 40), 130), ((1, 2, 100, 256), 100),
                             ((1, 2, 100, 8), 70)]


@pytest.mark.gpu
@pytest.mark.parametrize("qshape,sk", FWD_SHAPES)
def test_flash_fwd_kernel_matches_plain_on_card(hopper, qshape, sk):
    q, k, v = _bshd_views(hopper, qshape, sk, 60)
    scale = qshape[-1] ** -0.5
    before = _kernels.launches["flash_fwd"]
    out, lse = tflash.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_fwd"] == before + 1
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, scale)
    # the two round p at different offsets; the LSE is fp32 over the same
    # bf16 logits
    assert _attn_close(out, ref)
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("qshape,sk", [((1, 2, 300, 40), 300),
                                       ((1, 2, 100, 160), 333)])
def test_flash_fwd_kernel_head_major_on_card(hopper, qshape, sk):
    """The forward over contiguous head-major (B, H, S, D) tensors: the
    tensor maps take the other stride order."""
    b, h, sq, d = qshape
    q, k, v = (torch.from_numpy(_rand(s, b, h, n, d)).to(hopper,
                                                         torch.bfloat16)
               for s, n in ((90, sq), (91, sk), (92, sk)))
    out, lse = tflash.flash_fwd(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, d ** -0.5)
    assert _attn_close(out, ref)
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 80, 160])
def test_flash_fwd_kernel_late_max_on_card(hopper, d):
    """Every row's maximum lies in the last keys (280..299, past every tile
    boundary): the running max must rescale all earlier tiles' sums."""
    q, k, v = _aligned(85, 1, 2, 200, 300, d, 0.5, 0.5, 6.0, 280)
    assert (np.einsum("bhqd,bhkd->bhqk", q, k).argmax(-1) >= 280).all()
    q, k, v = (torch.from_numpy(a).to(hopper, torch.bfloat16)
               for a in (q, k, v))
    out, lse = tflash.flash_fwd(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, d ** -0.5)
    assert _attn_close(out, ref)
    assert (lse - ref_lse).abs().max().item() < 1e-3


# the backward's own edges on the wgmma kernels: each main-path head dim at
# q and key counts no 32-, 64- or 128-row tile divides, fewer q rows than
# one 128-row tile, 77 keys at d = 80
BWD_SHAPES = TRAIN_SHAPES + [((1, 2, 333, 40), 300), ((1, 2, 200, 80), 333),
                             ((1, 2, 300, 160), 130), ((1, 2, 100, 40), 130),
                             ((1, 2, 90, 80), 77)]


def _bwd_matches_plain(q, k, v, do, scale):
    """flash_bwd on the card (one dq and one dk/dv launch) against the
    plain backward on the same inputs."""
    o, lse = tflash.flash_attention_ref(q, k, v, scale)
    before = (_kernels.launches["flash_bwd_dq"],
              _kernels.launches["flash_bwd_dkv"])
    grads = tbwd.flash_bwd(q, k, v, o, do, lse, scale)
    torch.cuda.synchronize()
    assert (_kernels.launches["flash_bwd_dq"],
            _kernels.launches["flash_bwd_dkv"]) == (before[0] + 1,
                                                    before[1] + 1)
    refs = tbwd.flash_bwd_ref(q, k, v, o, do, lse, scale)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.shape == r.shape and g.dtype == torch.bfloat16
        assert torch.isfinite(g).all(), name
        assert _attn_close(g, r), name
    return lse


@pytest.mark.gpu
def test_fold_rounds_once_on_card(hopper):
    """The backward's folds (one bf16 multiply by a Python float) give the
    explicit fp32 round trip's values on the card, bit for bit."""
    x = torch.from_numpy(_rand(76, 1 << 20) * np.exp(_rand(77, 1 << 20) * 3))
    x = x.to(hopper, torch.bfloat16)
    for mult in (40 ** -0.5, 80 ** -0.5, 160 ** -0.5, tbwd.LOG2E):
        assert torch.equal(tbwd._fold(x, mult),
                           (x.float() * mult).to(torch.bfloat16)), mult


@pytest.mark.gpu
@pytest.mark.parametrize("qshape,sk", BWD_SHAPES)
def test_flash_bwd_kernels_match_plain_on_card(hopper, qshape, sk):
    q, k, v = _bshd_views(hopper, qshape, sk, 70)
    do = torch.from_numpy(_rand(75, *qshape)).to(hopper, torch.bfloat16)
    _bwd_matches_plain(q, k, v, do, qshape[-1] ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("qshape,sk", [((1, 2, 300, 40), 300),
                                       ((2, 3, 200, 80), 77),
                                       ((1, 2, 100, 160), 333)])
def test_flash_bwd_kernels_head_major_on_card(hopper, qshape, sk):
    """The backward over contiguous head-major (B, H, S, D) tensors: the
    tensor maps take the other stride order."""
    b, h, sq, d = qshape
    q, k, v, do = (torch.from_numpy(_rand(s, b, h, n, d)).to(hopper,
                                                             torch.bfloat16)
                   for s, n in ((94, sq), (95, sk), (96, sk), (97, sq)))
    _bwd_matches_plain(q, k, v, do, d ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 80, 160, 512])
def test_flash_bwd_kernels_far_negative_lse_on_card(hopper, d):
    """Six q rows (across tiles and warps) whose every logit is far below 0
    (lse2 near -185) among ordinary rows: a zero-filled key past Sk = 300
    would give p = exp2(-lse2) = inf in those rows, so only the last KV
    tile's mask keeps dq finite.  (Rows that are all far negative need
    keys sharing one strong direction; dq then cancels that common part,
    so only a few such rows keep the comparison well conditioned.)"""
    rows = [0, 37, 64, 101, 150, 199]
    scale = d ** -0.5
    u = _rand(98, d)
    u /= np.linalg.norm(u)
    b = 20.0  # the keys' common part; those rows' logits ~ -150 natural
    q = _rand(99, 1, 2, 200, d)
    q[:, :, rows] = _rand(103, 1, 2, len(rows), d, scale=0.1) \
        - 150.0 / (b * scale) * u
    k = _rand(100, 1, 2, 300, d) + b * u
    q, k, v, do = (torch.from_numpy(a).to(hopper, torch.bfloat16)
                   for a in (q, k, _rand(101, 1, 2, 300, d),
                             _rand(102, 1, 2, 200, d)))
    lse = _bwd_matches_plain(q, k, v, do, scale)
    # exp2(-lse2) overflows in those rows
    assert lse[..., rows].max().item() * tbwd.LOG2E < -128


# Against an fp64 backward, the dq kernel's error on every-row-far-negative
# inputs may be at most this multiple of the fp32 plain backward's own
# error on the same bf16 inputs: both round ds0 to bf16 and sum the common
# key direction that dq cancels, so their errors are of one size.
FAR_NEGATIVE_FP64_FACTOR = 2.0


@pytest.mark.gpu
@pytest.mark.parametrize("d", [80, 160, 512])
def test_flash_bwd_far_negative_all_rows_against_fp64_on_card(hopper, d):
    """Why the far-negative test above keeps ordinary rows among the far
    ones: when EVERY q row's logits sit near -150 (natural), the keys share
    one strong direction b·u whose part dq = Σ ds0·kl cancels, so dq is
    ill-conditioned.  Held against fp64, the dq kernel is as far off as
    the fp32 plain backward (within FAR_NEGATIVE_FP64_FACTOR of its
    error): the error is the input's, not the kernel's."""
    scale = d ** -0.5
    u = _rand(98, d)
    u /= np.linalg.norm(u)
    b = 20.0
    q = _rand(103, 1, 2, 200, d, scale=0.1) - 150.0 / (b * scale) * u
    k = _rand(100, 1, 2, 300, d) + b * u
    q, k, v, do = (torch.from_numpy(a).to(hopper, torch.bfloat16)
                   for a in (q, k, _rand(101, 1, 2, 300, d),
                             _rand(102, 1, 2, 200, d)))
    o, lse = tflash.flash_attention_ref(q, k, v, scale)
    assert lse.max().item() * tbwd.LOG2E < -128  # every row far negative
    dq = tbwd.flash_bwd(q, k, v, o, do, lse, scale)[0]
    torch.cuda.synchronize()
    plain = tbwd.flash_bwd_ref(q, k, v, o, do, lse, scale)[0]
    # the exact gradient of softmax(scale·q·kᵀ)·v in fp64 on the same
    # bf16 values (the plain versions compute in fp32 whatever they get)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    p64 = torch.softmax(scale * q64 @ k64.transpose(-1, -2), dim=-1)
    dp64 = do64 @ v64.transpose(-1, -2)
    delta64 = (do64 * (p64 @ v64)).sum(-1, keepdim=True)
    exact = scale * (p64 * (dp64 - delta64)) @ k64
    err = (dq.double() - exact).abs().max().item()
    plain_err = (plain.double() - exact).abs().max().item()
    print(f"d={d}: dq kernel err {err:.3e}, fp32 plain err {plain_err:.3e} "
          f"(ratio {err / plain_err:.2f}), |dq| max "
          f"{exact.abs().max().item():.3e}")
    assert torch.isfinite(dq).all()
    assert err <= FAR_NEGATIVE_FP64_FACTOR * plain_err


@pytest.mark.gpu
def test_flash_autograd_on_card_launches_all_three(hopper):
    q, k, v = (t.detach().requires_grad_(True)
               for t in _bshd_views(hopper, (1, 2, 256, 40), 256, 80))
    do = torch.from_numpy(_rand(85, 1, 2, 256, 40)).to(hopper, torch.bfloat16)
    before = dict(_kernels.launches)
    tflash.flash_attention(q, k, v).backward(do)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _kernels.launches[name] == before[name] + 1
    scale = 40 ** -0.5
    o, lse = tflash.flash_attention_ref(q.detach(), k.detach(), v.detach(),
                                        scale)
    refs = tbwd.flash_bwd_ref(q.detach(), k.detach(), v.detach(), o, do, lse,
                              scale)
    for name, g, r in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad),
                          refs):
        assert g.shape == r.shape and _attn_close(g, r), name


@pytest.mark.gpu
@pytest.mark.parametrize("n", [16384, 40000, 2048 * 300 + 7])
def test_adam8_kernel_matches_plain_on_card(hopper, n):
    p0 = torch.from_numpy(_rand(90, n, scale=0.5)).to(hopper)
    opt = tadam8.adamw8bit(1e-3, weight_decay=1e-2)
    st_k, st_r = opt.leaf_init(p0), opt.leaf_init(p0)
    pk, pr = p0.clone(), p0.clone()
    before = _kernels.launches["adam8"]
    for step in range(1, 4):
        g = torch.from_numpy(_rand(90 + step, n, scale=0.1)).to(hopper)
        tadam8.adam8_update(pk, g, st_k, 1e-3, step, b1=0.9, b2=0.999,
                            eps=1e-8, wd=1e-2)
        tadam8.adam8_update_ref(pr, g, st_r, 1e-3, step, b1=0.9, b2=0.999,
                                eps=1e-8, wd=1e-2)
    torch.cuda.synchronize()
    assert _kernels.launches["adam8"] == before + 3
    # fp32 on both sides, FMA contraction and sqrt/exp rounding only
    assert (pk - pr).abs().max().item() < 1e-6
    for a, b in ((st_k.mq, st_r.mq), (st_k.vq, st_r.vq)):
        d = (a.int() - b.int()).abs()
        assert d.max().item() <= 1 and d.float().mean().item() <= 1e-3
    torch.testing.assert_close(st_k.ms, st_r.ms, rtol=1e-5, atol=0)
    torch.testing.assert_close(st_k.vs, st_r.vs, rtol=1e-5, atol=0)
    if n % 2048:  # the ragged tail of the last row is never written
        assert st_k.mq.reshape(-1)[n:].abs().max().item() == 0


# the one-launch 8-bit AdamW over a list of leaves: a ragged last row, a
# stacked leaf whose rows straddle its parts (the text encoder's 12 fc1
# biases), one whose part length is no multiple of 16 (the kernel's
# element-by-element path), full rows
ADAM8_LEAVES = [(1, (2048 * 300 + 7,)), (12, (3072,)), (3, (3000,)),
                (4, (16384,)), (1, (64, 2048))]


def _adam8_leaves(hopper, seed):
    opt = tadam8.adamw8bit(1e-3, weight_decay=1e-2, min_8bit_size=4096)
    leaves = [[torch.from_numpy(_rand(seed + 20 * i + j, *shape,
                                      scale=0.5)).to(hopper)
               for j in range(parts)]
              for i, (parts, shape) in enumerate(ADAM8_LEAVES)]
    return leaves, [opt.leaf_init(leaf) for leaf in leaves]


def _adam8_grads(hopper, leaves, seed):
    return [[torch.from_numpy(_rand(seed + 20 * i + j, *p.shape,
                                    scale=0.1)).to(hopper)
             for j, p in enumerate(leaf)] for i, leaf in enumerate(leaves)]


def _clone_leaves(leaves, states):
    return ([[p.clone() for p in leaf] for leaf in leaves],
            [tadam8.Quant8State(*(x.clone() for x in (st.mq, st.ms, st.vq,
                                                      st.vs)))
             for st in states])


@pytest.mark.gpu
def test_adam8_leaves_kernel_matches_plain_on_card(hopper):
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-2)
    pk, sk = _adam8_leaves(hopper, 200)
    assert all(isinstance(s, tadam8.Quant8State) for s in sk)
    pr, sr = _clone_leaves(pk, sk)
    before = _kernels.launches["adam8"]
    for step in range(1, 4):
        g = _adam8_grads(hopper, pk, 300 + 10 * step)
        tadam8.adam8_update_leaves(list(zip(pk, g, sk)), 1e-3, step, **kw)
        tadam8.adam8_update_leaves_ref(list(zip(pr, g, sr)), 1e-3, step,
                                       **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["adam8"] == before + 3  # one launch a step
    # the K7 limits of chip_smoke.py (fp32 both sides; FMA contraction and
    # the special-function unit's sqrt and reciprocal)
    for lk, lr_ in zip(pk, pr):
        for a, b in zip(lk, lr_):
            assert (a - b).abs().max().item() < 1e-6
    for a, b in zip(sk, sr):
        for x, y in ((a.mq, b.mq), (a.vq, b.vq)):
            d = (x.int() - y.int()).abs()
            assert d.max().item() <= 1 and d.float().mean().item() <= 1e-3
        torch.testing.assert_close(a.ms, b.ms, rtol=1e-5, atol=0)
        torch.testing.assert_close(a.vs, b.vs, rtol=1e-5, atol=0)
    n = ADAM8_LEAVES[0][1][0]  # the ragged tail of the last row stays 0
    assert sk[0].mq.reshape(-1)[n:].abs().max().item() == 0


@pytest.mark.gpu
def test_adam8_leaves_refuses_a_misaligned_part_on_card(hopper):
    parts, states = _adam8_leaves(hopper, 600)
    g = _adam8_grads(hopper, parts, 700)
    parts[1][5] = torch.zeros(3073, device=hopper)[1:]  # 4 bytes off
    before = _kernels.launches["adam8"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        tadam8.adam8_update_leaves(list(zip(parts, g, states)), 1e-3, 1,
                                   b1=0.9, b2=0.999, eps=1e-8, wd=1e-2)
    assert _kernels.launches["adam8"] == before


# the kernels of the switches (csrc/group_norm_sm90.cu, the K9 variant of
# csrc/flash_fwd_sm90.cu, csrc/flash_int8_sm90.cu) and the 512-wide forward


def _gn_inputs(dev, shape, dtype, pdtype=torch.float32, seed=100):
    x = (torch.from_numpy(_rand(seed, *shape)) * 2 + 0.5).to(dev, dtype)
    c = shape[-1]
    w = torch.from_numpy(_rand(seed + 1, c) * 0.3 + 1.0).to(dev, pdtype)
    b = torch.from_numpy(_rand(seed + 2, c) * 0.2).to(dev, pdtype)
    return x, w, b


@pytest.mark.gpu
@pytest.mark.parametrize("shape,groups,act,dtype,pdtype", [
    ((2, 64, 64, 320), 32, "silu", torch.bfloat16, torch.float32),
    ((2, 32, 32, 640), 32, "silu", torch.bfloat16, torch.float32),
    ((2, 8, 8, 1280), 32, None, torch.bfloat16, torch.float32),
    ((2, 10, 20, 96), 32, "silu", torch.bfloat16, torch.float32),
    ((3, 7, 5, 40), 8, None, torch.float32, torch.float32),
    # the cap's largest bf16 slice (3 MiB, 16 CTAs of 192 KiB)
    ((1, 32, 32, 1536), 32, "silu", torch.bfloat16, torch.float32),
    # fp32 at the 6 MiB cap: rows past shared memory read again
    ((1, 64, 64, 384), 32, None, torch.float32, torch.float32),
    ((8, 64, 64, 320), 32, "silu", torch.bfloat16, torch.bfloat16),
    ((8, 16, 16, 2560), 32, "silu", torch.bfloat16, torch.bfloat16),
    ((1, 8, 8, 1280), 32, "silu", torch.bfloat16, torch.bfloat16),
    # rows that are not whole 16-byte vectors: the element path
    ((2, 6, 7, 36), 4, "silu", torch.bfloat16, torch.float32),
    ((2, 6, 7, 36), 4, None, torch.float32, torch.bfloat16)])
def test_group_norm_kernel_matches_plain_on_card(hopper, shape, groups, act,
                                                 dtype, pdtype):
    x, w, b = _gn_inputs(hopper, shape, dtype, pdtype)
    before = _kernels.launches["gn_fused"]
    y = tpgn.fused_group_norm(x, w, b, groups, 1e-5, act)
    torch.cuda.synchronize()
    assert _kernels.launches["gn_fused"] == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    ref = tpgn.group_norm_fused_ref(x.float(), w, b, groups, 1e-5, act)
    # one rounding to the output type, plus fp32 summation order
    ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    assert ((y.float() - ref).abs() <= ulp * ref.abs() + 1e-3).all()


@pytest.mark.gpu
@pytest.mark.parametrize("span", [12.0, 60.0])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_kernel_silu_over_its_range_on_card(hopper, dtype, span):
    """SiLU at every normalised value from -span to span (65536 steps),
    where the kernel's approximate exponential and reciprocals (ex2.approx,
    rcp.approx on even channels, Newton's on odd ones, its exponent clamped
    below -44) meet their extremes: within one output rounding plus 1e-3 of
    the plain version."""
    n = 64 * 1024
    x = torch.linspace(-1.0, 1.0, n, device=hopper).reshape(1, n // 32, 32)
    x = x.to(dtype)
    w = torch.full((32,), span * x.float().std(unbiased=False).item(),
                   device=hopper)  # normalised x times w: from -span to span
    b = torch.zeros(32, device=hopper)
    y = tpgn.fused_group_norm(x, w, b, 1, 1e-6, "silu")
    ref = tpgn.group_norm_fused_ref(x.float(), w, b, 1, 1e-6, "silu")
    assert ref.min().item() < -0.05 and ref.max().item() > 0.9 * span
    ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    assert ((y.float() - ref).abs() <= ulp * ref.abs() + 1e-3).all()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((8, 64, 64, 320), torch.bfloat16), ((1, 64, 64, 384), torch.float32),
    ((2, 10, 20, 96), torch.bfloat16)])
def test_group_norm_kernel_is_deterministic_on_card(hopper, shape, dtype):
    """The cluster's CTAs sum the partials in rank order: two calls give
    the same bits (no atomics)."""
    x, w, b = _gn_inputs(hopper, shape, dtype, seed=110)
    y1 = tpgn.fused_group_norm(x, w, b, 32, 1e-5, "silu")
    y2 = tpgn.fused_group_norm(x, w, b, 32, 1e-5, "silu")
    assert torch.equal(y1.view(torch.int16 if dtype == torch.bfloat16
                               else torch.int32),
                       y2.view(torch.int16 if dtype == torch.bfloat16
                               else torch.int32))


@pytest.mark.gpu
def test_group_norm_kernel_is_one_launch_on_card(hopper):
    """One call is one CUDA kernel, the fused one: bf16 scale and bias are
    read in their dtype (no cast kernel), no scratch is cleared."""
    from torch.profiler import ProfilerActivity, profile

    x, w, b = _gn_inputs(hopper, (8, 32, 32, 640), torch.bfloat16,
                         torch.bfloat16, seed=120)
    tpgn.fused_group_norm(x, w, b, 32, 1e-5, "silu")  # plan and occupancy
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tpgn.fused_group_norm(x, w, b, 32, 1e-5, "silu")
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "gn_cluster_kernel" in kernels[0], kernels


@pytest.mark.gpu
def test_group_norm_kernel_gradient_on_card(hopper):
    x = torch.from_numpy(_rand(103, 2, 16, 16, 64)).to(hopper)
    w = torch.from_numpy(_rand(104, 64)).to(hopper)
    b = torch.from_numpy(_rand(105, 64)).to(hopper)
    xs = [t.clone().requires_grad_(True) for t in (x, w, b)]
    ys = [t.clone().requires_grad_(True) for t in (x, w, b)]
    (tpgn.fused_group_norm(*xs, 16, 1e-6, "silu") ** 2).sum().backward()
    (tpgn.group_norm_fused_ref(*ys, 16, 1e-6, "silu") ** 2).sum().backward()
    for a, r in zip(xs, ys):
        torch.testing.assert_close(a.grad, r.grad, atol=1e-3, rtol=1e-3)


TT_SHAPES = [((1, 2, 256, 40), 256), ((1, 2, 140, 40), 77),
             ((2, 8, 64, 160), 64), ((1, 2, 200, 80), 300),
             ((1, 1, 256, 512), 256), ((1, 1, 100, 320), 77)]


@pytest.mark.gpu
@pytest.mark.parametrize("qshape,sk", TT_SHAPES)
def test_flash_tt_kernel_matches_plain_on_card(hopper, qshape, sk):
    q, k, v = _bshd_views(hopper, qshape, sk, 110)
    scale = qshape[-1] ** -0.5
    before = _kernels.launches["flash_tt"]
    out, lse = ttt.flash_fwd_tt(q, k, v, scale)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_tt"] == before + 1
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, scale)
    assert out.shape == ref.shape and _attn_close(out, ref)
    assert (lse - ref_lse).abs().max().item() < 1e-3
    k5, _ = tflash.flash_fwd(q, k, v, scale)  # the same function
    assert _attn_close(out, k5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 24, 48, 64, 96, 128, 144, 192, 200, 256])
def test_flash_tt_sm90_kernel_takes_every_head_dim_on_card(hopper, d):
    """Each instantiation of the wgmma kernel's head-dim-major variant (the
    k16 steps of Q.K^T, 16 KS head-dim rows a tile), at ragged q and key
    counts over several heads: against the plain version and K5."""
    q, k, v = _bshd_views(hopper, (2, 3, 130, d), 200, 140)
    scale = d ** -0.5
    before = _kernels.launches["flash_tt"]
    out, lse = ttt.flash_fwd_tt(q, k, v, scale)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_tt"] == before + 1
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, scale)
    assert out.shape == ref.shape and _attn_close(out, ref)
    assert (lse - ref_lse).abs().max().item() < 1e-3
    k5, _ = tflash.flash_fwd(q, k, v, scale)
    assert _attn_close(out, k5)


@pytest.mark.gpu
def test_flash_tt_autograd_on_card(hopper):
    q, k, v = (t.detach().requires_grad_(True)
               for t in _bshd_views(hopper, (1, 2, 256, 40), 77, 120))
    do = torch.from_numpy(_rand(125, 1, 2, 256, 40)).to(hopper,
                                                        torch.bfloat16)
    before = dict(_kernels.launches)
    ttt.flash_attention_tt(q, k, v).backward(do)
    torch.cuda.synchronize()
    for name in ("flash_tt", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _kernels.launches[name] == before[name] + 1
    assert _kernels.launches["flash_fwd"] == before["flash_fwd"]
    scale = 40 ** -0.5
    o, lse = tflash.flash_attention_ref(q.detach(), k.detach(), v.detach(),
                                        scale)
    refs = tbwd.flash_bwd_ref(q.detach(), k.detach(), v.detach(), o, do, lse,
                              scale)
    for name, g, r in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad),
                          refs):
        assert _attn_close(g, r), name


@pytest.mark.gpu
@pytest.mark.parametrize("qshape,sk", [((1, 1, 256, 512), 256),
                                       ((1, 1, 100, 320), 77)])
def test_flash_fwd_kernel_takes_wide_heads_on_card(hopper, qshape, sk):
    """The VAE's 512-wide head under SDBC_ATTN_IMPL=flash."""
    q, k, v = _bshd_views(hopper, qshape, sk, 130)
    scale = qshape[-1] ** -0.5
    before = _kernels.launches["flash_fwd"]
    out, lse = tflash.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_fwd"] == before + 1
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, scale)
    assert _attn_close(out, ref)
    assert (lse - ref_lse).abs().max().item() < 1e-3
    # the backward takes the same heads (the JAX backward pads any head dim)
    do = torch.from_numpy(_rand(131, *qshape)).to(hopper, torch.bfloat16)
    _bwd_matches_plain(q, k, v, do, scale)


# the wide forward (csrc/flash_fwd_wide_sm90.cu, head dims above 256): each
# instantiation (consumer 1's 64-column blocks: 1 to 4), ragged q and key
# counts that leave the second CTA of a pair 72 keys (Sk 200), 13 (Sk 77),
# none (Sk 64 and 30), several heads over projection-layout strides
WIDE_D = [264, 320, 448, 512]
WIDE_SQ_SK = [(130, 200), (100, 77), (70, 64), (64, 30)]


def _wide_fwd(layout):
    return ((tflash.flash_fwd, "flash_fwd") if layout == "natural"
            else (ttt.flash_fwd_tt, "flash_tt"))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["natural", "tt"])
@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("sq,sk", WIDE_SQ_SK)
def test_flash_fwd_wide_kernel_matches_plain_on_card(hopper, layout, d, sq,
                                                     sk):
    q, k, v = _bshd_views(hopper, (2, 3, sq, d), sk, 150)
    scale = d ** -0.5
    fwd, name = _wide_fwd(layout)
    before = _kernels.launches[name]
    out, lse = fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert _kernels.launches[name] == before + 1
    ref, ref_lse = tflash.flash_attention_ref(q, k, v, scale)
    assert out.shape == ref.shape and _attn_close(out, ref)
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("qshape,sk", [((1, 1, 4096, 512), 4096),
                                       ((2, 3, 130, 512), 77),
                                       ((1, 2, 70, 320), 64)])
def test_flash_fwd_wide_tt_equals_natural_on_card(hopper, qshape, sk):
    """K9's output and LSE equal K5's bit for bit at the wide heads: the two
    layouts differ only in the operands' majors."""
    q, k, v = _bshd_views(hopper, qshape, sk, 160)
    scale = qshape[-1] ** -0.5
    out, lse = tflash.flash_fwd(q, k, v, scale)
    out_tt, lse_tt = ttt.flash_fwd_tt(q, k, v, scale)
    torch.cuda.synchronize()
    assert torch.equal(out_tt, out) and torch.equal(lse_tt, lse)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["natural", "tt"])
@pytest.mark.parametrize("d", [320, 512])
def test_flash_fwd_wide_one_key_is_exact_on_card(hopper, layout, d):
    """One key: p = 1 and l = 1, so every output row is v's row exactly and
    the LSE is the logit; the second CTA of each pair has no keys, and its
    (m = -1e30, l = 0, O = 0) must leave the result untouched."""
    q, k, v = _bshd_views(hopper, (1, 2, 130, d), 1, 170)
    scale = d ** -0.5
    fwd, _ = _wide_fwd(layout)
    out, lse = fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert torch.equal(out, v.expand_as(out))
    _, ref_lse = tflash.flash_attention_ref(q, k, v, scale)
    assert (lse - ref_lse).abs().max().item() < 1e-3


# the wide backward (csrc/flash_bwd_wide_sm90.cu): head dims that split
# evenly and unevenly over the cluster's two CTAs (CTA 1's columns end
# inside its column blocks at 264, 320 and 448), q and key counts no 32- or
# 64-row tile divides
BWD_WIDE_D = [200, 256, 264, 320, 448, 512]


def _wide_bwd_inputs(hopper, layout, qshape, sk, seed):
    """q, k, v, dO: (B, H, S, D) views over (B, S, H, D) memory, or
    contiguous head-major tensors."""
    b, h, sq, d = qshape
    if layout == "bshd":
        q, k, v = _bshd_views(hopper, qshape, sk, seed)
        do = torch.from_numpy(_rand(seed + 3, b, sq, h, d)).to(
            hopper, torch.bfloat16).transpose(1, 2)
        return q, k, v, do
    return [torch.from_numpy(_rand(seed + i, b, h, n, d)).to(
        hopper, torch.bfloat16) for i, n in enumerate((sq, sk, sk, sq))]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
@pytest.mark.parametrize("d", BWD_WIDE_D)
@pytest.mark.parametrize("sq,sk", [(130, 200), (100, 77)])
def test_flash_bwd_kernels_take_wide_heads_on_card(hopper, layout, d, sq,
                                                   sk):
    """The TMA-fed wgmma backward above 192, in both layouts: one dq and
    one dk/dv launch, gradients as the plain backward's."""
    q, k, v, do = _wide_bwd_inputs(hopper, layout, (1, 2, sq, d), sk, 132)
    _bwd_matches_plain(q, k, v, do, d ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [264, 512])
def test_flash_bwd_wide_one_key_on_card(hopper, d):
    """One key: the dq kernel's only key tile masks 31 of its 32 keys, and
    every q row's p is 1."""
    q, k, v, do = _wide_bwd_inputs(hopper, "bshd", (1, 2, 70, d), 1, 142)
    _bwd_matches_plain(q, k, v, do, d ** -0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [200, 320, 512])
def test_flash_bwd_wide_is_deterministic_on_card(hopper, d):
    """Two calls give the same bits: no atomics, every sum in one order
    (the two CTAs' score partials added the same way in both)."""
    q, k, v, do = _wide_bwd_inputs(hopper, "bshd", (2, 2, 300, d), 333, 146)
    scale = d ** -0.5
    o, lse = tflash.flash_attention_ref(q, k, v, scale)
    first = tbwd.flash_bwd(q, k, v, o, do, lse, scale)
    second = tbwd.flash_bwd(q, k, v, o, do, lse, scale)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
def test_flash_autograd_wide_head_on_card(hopper):
    """The VAE's 512-wide head through ``_FlashAttention``: one forward,
    one dq and one dk/dv launch, gradients as the plain backward's."""
    q, k, v = (t.detach().requires_grad_(True)
               for t in _bshd_views(hopper, (1, 1, 300, 512), 300, 134))
    do = torch.from_numpy(_rand(135, 1, 1, 300, 512)).to(hopper,
                                                          torch.bfloat16)
    before = dict(_kernels.launches)
    tflash.flash_attention(q, k, v).backward(do)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert _kernels.launches[name] == before[name] + 1
    scale = 512 ** -0.5
    o, lse = tflash.flash_attention_ref(q.detach(), k.detach(), v.detach(),
                                        scale)
    refs = tbwd.flash_bwd_ref(q.detach(), k.detach(), v.detach(), o, do, lse,
                              scale)
    for name, g, r in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad),
                          refs):
        assert g.shape == r.shape and _attn_close(g, r), name


def _int8_inputs(hopper, qshape, sk, seed=140):
    b, h, sq, d = qshape
    q = torch.from_numpy(_rand(seed, *qshape)).to(hopper, torch.bfloat16)
    k, v = (torch.from_numpy(_rand(s, b, h, sk, d)).to(hopper, torch.bfloat16)
            for s in (seed + 1, seed + 2))
    return q, k, v


def _int8_close(out, q, k, v):
    """Within ``_attn_close`` of the plain version and within 4% of the
    largest output of exact attention (JAX's bound, tests/test_ops.py)."""
    assert _attn_close(out, tflash.fixed_cap_int8_ref(q, k, v).float())
    exact = tattn.plain_attention(q.float(), k.float(), v.float())
    assert ((out.float() - exact).abs().max()
            / exact.abs().max()).item() < 0.04


@pytest.mark.gpu
@pytest.mark.parametrize("qshape,sk", [((2, 8, 1024, 80), 1024),
                                       ((1, 2, 512, 40), 512),
                                       ((1, 2, 200, 160), 300),
                                       ((1, 2, 64, 16), 77),
                                       ((1, 2, 200, 256), 130)])
def test_int8_kernel_matches_plain_on_card(hopper, qshape, sk):
    """Each call is counted exactly (the pre-pass and the attention
    kernel: two launches); two calls give the same bits."""
    q, k, v = _int8_inputs(hopper, qshape, sk)
    before = _kernels.launches["flash_fixed_int8"]
    out = tflash.flash_attention_fixed_int8(q, k, v)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_fixed_int8"] == before + 2
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    _int8_close(out, q, k, v)
    again = tflash.flash_attention_fixed_int8(q, k, v)
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))


@pytest.mark.gpu
def test_int8_kernel_reads_projection_layout_views_on_card(hopper):
    """(B, H, S, D) views of (B, S, H, D) projections go in through their
    strides: the same bits as on contiguous copies."""
    views = _bshd_views(hopper, (2, 4, 300, 80), 333, 150)
    out = tflash.flash_attention_fixed_int8(*views)
    flat = tflash.flash_attention_fixed_int8(*(t.contiguous()
                                               for t in views))
    assert not views[0].is_contiguous()
    assert torch.equal(out.view(torch.int16), flat.view(torch.int16))
    _int8_close(out, *views)


@pytest.mark.gpu
def test_int8_kernel_zero_rows_on_card(hopper):
    """All-zero q and k rows take the 1e-8 absmax floor: zero int8 values,
    a zero row of scores, finite outputs as the plain version's."""
    q, k, v = _int8_inputs(hopper, (1, 2, 256, 40), 256, seed=160)
    q[0, 0, 5] = 0
    q[0, 1, 200] = 0
    k[0, 0, 17] = 0
    k[0, 1, 255] = 0
    out = tflash.flash_attention_fixed_int8(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    _int8_close(out, q, k, v)


@pytest.mark.gpu
def test_int8_kernel_launches_only_its_kernels_on_card(hopper):
    """One call is the pre-pass and the attention kernel: no torch launch
    quantizes, pads or copies."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = _int8_inputs(hopper, (2, 8, 1024, 80), 1024, seed=170)
    tflash.flash_attention_fixed_int8(q, k, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tflash.flash_attention_fixed_int8(q, k, v)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    want = ["quantize_k_kernel", "flash_int8_sm90_kernel"]
    assert len(kernels) == len(want) and all(
        w in n for w, n in zip(want, kernels)), kernels


# fp32 and the VAE's 512-wide fixed cap on the card: what the tensor-core
# kernels do not take goes to the CUDA-core kernels of the same functions,
# the fixed cap above head dim 256 to the wide kernel's fixed-cap variant


@pytest.mark.gpu
@pytest.mark.parametrize("qshape,sk", [((1, 1, 4096, 512), 4096),
                                       ((2, 2, 300, 512), 333),
                                       ((1, 2, 200, 264), 50),
                                       ((2, 1, 64, 320), 129),
                                       ((1, 1, 130, 448), 300)])
def test_flash_fixed_wide_matches_plain_on_card(hopper, qshape, sk):
    """The fixed cap above head dim 256 (csrc/flash_fwd_wide_sm90.cu's
    FIXED variant): against its plain version, head-major and through the
    projection layout's strides (the same bits), one ``flash_fixed``
    launch a call, two calls the same bits; keys ≤ 64 leave the second CTA
    of a pair none."""
    q, k, v = _bshd_views(hopper, qshape, sk, 210)
    before = _kernels.launches["flash_fixed"]
    out = tflash.flash_attention_fixed(q, k, v)
    torch.cuda.synchronize()
    assert _kernels.launches["flash_fixed"] == before + 1
    assert _attn_close(out, tflash.fixed_cap_attention_ref(q, k, v).float())
    tr = lambda t: t.transpose(1, 2)
    bshd = tr(tflash.flash_attention_fixed_bshd(tr(q), tr(k), tr(v)))
    again = tflash.flash_attention_fixed(q, k, v)
    assert torch.equal(out.view(torch.int16), bshd.view(torch.int16))
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))


@pytest.mark.gpu
def test_fp32_sampling_on_card_matches_cpu(hopper):
    """A tiny fp32 ``SDPipeline`` call on the card against the CPU's: the
    fixed-cap attention and the VAE's training-forward attention on the
    3xTF32 kernel, the fused FF on the 3xTF32 FF, no bf16 tensor-core
    launch."""
    from sdbc_tpu_torch.data.tokenizer import CLIPTokenizer
    from sdbc_tpu_torch.diffusion.pipeline import (PipelineConfig, SDPipeline,
                                                   init_models)
    from sdbc_tpu_torch.utils.prng import per_sample_fixed_latents

    cfg = PipelineConfig.tiny()
    models = init_models(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    tok = CLIPTokenizer.fallback(cfg.clip.vocab_size)
    # the same starting latents on both devices (a torch generator's draws
    # differ between the CPU and the card)
    kw = dict(height=32, width=32, num_inference_steps=4,
              latents=per_sample_fixed_latents(1, (4, 16, 16), 42))
    ref = SDPipeline(models, cfg, tok, "cpu", torch.float32)(["a cover"], **kw)
    card = {n: m.to("cuda") for n, m in models.items()}
    _kernels.reset_launch_counts()
    out = SDPipeline(card, cfg, tok, "cuda", torch.float32)(["a cover"], **kw)
    launched = {n for n, c in _kernels.launches.items() if c}
    assert launched == {"flash_fixed_tf32", "geglu_ff_tf32",
                        "flash_fwd_tf32"}, _kernels.launches
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= 3e-2  # chip_smoke.PARITY_TOL


@pytest.mark.gpu
def test_fp32_train_step_on_card_matches_cpu(hopper):
    """One tiny fp32 optimizer step (8-bit AdamW) on the card against the
    CPU's from the same masters and draws: the flash attention forward and
    backward on the 3xTF32 kernels, the optimizer its one launch."""
    import copy

    from sdbc_tpu_torch.diffusion.pipeline import PipelineConfig, init_models
    from sdbc_tpu_torch.train import trainer as ttrainer

    cfg = PipelineConfig.tiny()
    tcfg = ttrainer.TrainConfig(train_text_encoder=True, train_unet=True,
                                use_8bit_adam=True, grad_accum=2,
                                micro_batch=2, learning_rate=1e-3,
                                num_examples=100)
    base = init_models(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    f32 = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32))
    batch = {"pixel_values": f32(2, 2, 32, 32, 3) * 0.5,
             "input_ids": torch.from_numpy(rng.integers(
                 0, cfg.clip.vocab_size, (2, 2, cfg.clip.ctx)))}
    draws = [{"eps": f32(2, 16, 16, 4), "noise": f32(2, 16, 16, 4),
              "t": torch.from_numpy(rng.integers(0, 1000, (2,)))}
             for _ in range(2)]
    runs = {}
    for dev in ("cpu", "cuda"):
        state = ttrainer.init_train_state(copy.deepcopy(base), tcfg,
                                          compute_dtype=torch.float32,
                                          device=dev)
        step = ttrainer.make_train_step(cfg, tcfg, compute_dtype=torch.float32,
                                        device=dev)
        _kernels.reset_launch_counts()
        state, m = step(state, batch, draws=draws)
        runs[dev] = (m, [p.detach().float().cpu() for p in
                         ttrainer.trainable_params(state.trainable)],
                     dict(_kernels.launches))
    (mc, pc, _), (mg, pg, counts) = runs["cpu"], runs["cuda"]
    launched = {k: v for k, v in counts.items() if v}
    assert launched.pop("adam8") == 1
    assert set(launched) == {"flash_fwd_tf32", "flash_bwd_dq_tf32",
                             "flash_bwd_dkv_tf32"}, counts
    assert mg["finite"] and abs(mg["loss"] - mc["loss"]) <= 2e-2 * abs(
        mc["loss"])  # chip_smoke.TRAIN_LOSS_RTOL
    # Adam's first steps: within twice the step bound (chip_smoke's
    # TRAIN_STEP_BOUND × lr) of each other
    assert max(float((a - b).abs().max()) for a, b in zip(pg, pc)) \
        <= 2.2 * tcfg.learning_rate


@pytest.mark.gpu
def test_vae_decode_under_inference_on_card(hopper, monkeypatch):
    """The SD VAE's 512-wide mid-block head (256 tokens of a 16² latent)
    under ``SDBC_ATTN_IMPL=inference``: the fixed cap at head dim 512 on the
    wide kernel's fixed-cap variant (one launch), the image within twice
    the default bf16 decode's distance from an fp32 decode."""
    from sdbc_tpu_torch.models import vae as tvae

    cfg = tvae.VAEConfig()
    assert cfg.block_out_channels[-1] == 512
    model = tvae.init(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0),
                      dtype=torch.bfloat16)
    z = (torch.from_numpy(_rand(180, 1, 16, 16, cfg.latent_channels))
         / cfg.scaling_factor).to(hopper, torch.bfloat16)
    with torch.inference_mode():
        img = tvae.decode(model, z)
        monkeypatch.setenv("SDBC_ATTN_IMPL", "inference")
        _kernels.reset_launch_counts()
        img_inf = tvae.decode(model, z)
        torch.cuda.synchronize()
        monkeypatch.delenv("SDBC_ATTN_IMPL")
        img32 = tvae.decode(model.float(), z.float())
    assert {n: c for n, c in _kernels.launches.items() if c} \
        == {"flash_fixed": 1}
    assert img_inf.shape == (1, 128, 128, 3) and torch.isfinite(img_inf).all()
    e32 = (img.float() - img32).abs().max().item()
    assert (img_inf.float() - img.float()).abs().max().item() <= 2 * e32

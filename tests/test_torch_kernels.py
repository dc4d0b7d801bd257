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
from sdbc_tpu_torch.ops import geglu_ff as tgeglu
from sdbc_tpu_torch.utils.dtypes import set_fp32_matmul_exact


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


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
    (src / "flash_fixed.cu").write_text("// edited\n")
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
    assert _kernels.launches == {"flash_fixed": 0, "geglu_ff": 0}


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
    ("bhsd", (1, 2, 256, 40), 256), ("bhsd", (2, 1, 128, 80), 300)])
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
    # bf16 rounding of q, p and o against the fp32 plain version
    assert (out.float() - ref).abs().max().item() < 2e-2


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take(hopper):
    q = torch.zeros(1, 256, 2, 40, device=hopper)
    with pytest.raises(TypeError, match="bfloat16"):
        tflash.flash_attention_fixed_bshd(q, q, q)
    q = torch.zeros(1, 256, 2, 44, device=hopper, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8|aligned"):
        tflash.flash_attention_fixed_bshd(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,c", [(256, 32), (200, 64), (512, 320),
                                    (100, 384), (256, 640), (8192, 640)])
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
def test_geglu_kernel_refuses_what_it_does_not_take(hopper):
    args = [torch.from_numpy(a).to(hopper) for a in _geglu_inputs(64, 48)]
    for i in (0, 3, 4, 5, 6):
        args[i] = args[i].bfloat16()
    with pytest.raises(ValueError, match="multiple"):
        tgeglu.geglu_ff_rows(*args)

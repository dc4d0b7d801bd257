"""The fused GroupNorm's launch plan (``ops.pallas_groupnorm.plan``) and its
host path, on the CPU: no card, no JAX.

``plan`` lays one call of ``csrc/group_norm_sm90.cu`` out: one cluster of
up to 16 CTAs per sample, the sample's rows split over them and held in
their shared memory where it takes them.  These tests hold its invariants
at every UNet GroupNorm shape the eligibility rule admits (SD-1.5 at 512²:
the 64² latent and its 32², 16² and 8² levels) and at a ragged one.
"""
import pytest
import torch

from sdbc_tpu_torch.ops import _kernels
from sdbc_tpu_torch.ops import pallas_groupnorm as tpgn
from tests.torch_threads import one_thread  # noqa: F401

# (hw, c) of the UNet's 57 eligible GroupNorm sites per evaluation
UNET_SHAPES = [(64 * 64, 320), (32 * 32, 320), (32 * 32, 640),
               (32 * 32, 960), (32 * 32, 1280), (16 * 16, 640),
               (16 * 16, 1280), (16 * 16, 1920), (16 * 16, 2560),
               (8 * 8, 1280), (8 * 8, 2560)]
CASES = [(n, hw, c, 32, dt) for hw, c in UNET_SHAPES for n in (1, 2, 8)
         for dt in (torch.bfloat16, torch.float32)] \
    + [(2, 200, 96, 32, torch.bfloat16), (2, 200, 96, 32, torch.float32),
       (3, 42, 36, 4, torch.bfloat16)]

# cudaOccupancyMaxActiveClusters of the kernel for clusters of 1..16 CTAs
# on an H100 SXM (chip_smoke.py's build line): CTAs of one an SM (512
# threads, 227 KB of shared memory) and of two (256 threads, 113 KB).
H100_ONE = (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)
H100_TWO = (264, 132, 79, 62, 47, 39, 32, 30, 23, 21, 16, 16, 14, 14, 14, 14)


def h100_like(cs, threads, smem):
    """The readings above for a CTA of ``threads`` threads (up to 128
    registers each) and ``smem`` bytes: two fit an SM when both the 64K
    registers and the 228 KB (1 KB kept for each block) allow it."""
    two = 2 * 128 * threads <= 65536 and 2 * (smem + 1024) <= 233472
    return (H100_TWO if two else H100_ONE)[cs - 1]


def _elem(dtype):
    return 2 if dtype == torch.bfloat16 else 4


def test_unet_shapes_are_eligible():
    for hw, c in UNET_SHAPES:
        assert tpgn.fits((8, hw, c), 32)
    assert not tpgn.fits((8, 64 * 64, 640), 32)


@pytest.mark.parametrize("occupancy", [None, h100_like], ids=["all", "h100"])
@pytest.mark.parametrize("n,hw,c,groups,dtype", CASES)
def test_plan_invariants(n, hw, c, groups, dtype, occupancy):
    p = tpgn.plan(n, hw, c, dtype, groups, occupancy)
    elem, row = _elem(dtype), c * _elem(dtype)
    assert 1 <= p.cluster <= 16 and p.cluster <= hw
    # every row exactly once, in order, split evenly
    ranges = p.row_ranges()
    assert ranges[0][0] == 0 and ranges[-1][1] == hw
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [b - a for a, b in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert max(sizes) == p.rows_max
    # the thread layout: (lane, column) items cover the vectors of a row
    nv = c // p.vec
    assert c % p.vec == 0 and p.threads % 32 == 0
    assert p.lanes * p.cv <= p.threads <= tpgn.MAX_THREADS
    assert p.cv * -(-nv // p.cv) >= nv and 1 <= p.lanes <= p.rows_max
    # shared memory: the resident slab fits beside the statistics, or the
    # plan reads the rest again
    head = tpgn.slab_offset(groups, p.cluster, p.lanes, p.cv, p.vec)
    assert p.smem == head + p.resident * row <= tpgn.SMEM_MAX
    assert p.resident <= p.rows_max
    assert p.reread == (p.resident < p.rows_max)
    if p.reread:
        assert head + (p.resident + 1) * row > tpgn.SMEM_MAX
    # the 16-byte path: every slab (one bulk copy) starts 16-byte aligned
    if p.vec > 1:
        assert p.vec * elem == 16 and row % 16 == 0
        assert all(a * row % 16 == 0 for a, _ in ranges)
    if occupancy is None:
        assert p.waves == 1


@pytest.mark.parametrize("hw,c", UNET_SHAPES)
def test_plan_keeps_the_unet_in_shared_memory_in_one_wave(hw, c):
    """At batch 8 in bf16 on an H100 every UNet site runs in one wave of
    9-CTA clusters (16-CTA clusters would take two), and reads x once but
    where a sample (1.875 or 2.5 MiB) outgrows 9 CTAs' shared memory."""
    p = tpgn.plan(8, hw, c, torch.bfloat16, 32, h100_like)
    assert (p.waves, p.vec, p.cluster) == (1, 8, 9)
    assert p.reread == ((hw, c) in {(64 * 64, 320), (32 * 32, 960),
                                    (32 * 32, 1280)})
    # at batch 7 the card holds 16-CTA clusters at once
    assert tpgn.plan(7, hw, c, torch.bfloat16, 32, h100_like).cluster == 16
    # the cap's largest bf16 slice fits 16 CTAs' shared memory
    assert not tpgn.plan(1, 32 * 32, 1536, torch.bfloat16).reread


def test_plan_prefers_one_wave():
    # a card that holds 7 clusters of 16 and 8 of anything smaller
    occ = lambda cs, threads, smem: 7 if cs > 12 else 8
    p = tpgn.plan(8, 64 * 64, 320, torch.bfloat16, 32, occ)
    assert p.cluster == 12 and p.waves == 1
    assert tpgn.plan(7, 64 * 64, 320, torch.bfloat16, 32, occ).cluster == 16
    # no cluster size fits in one wave: the fewest waves, then the largest
    p = tpgn.plan(64, 64 * 64, 320, torch.bfloat16, 32, occ)
    assert p.waves == 8 and p.cluster == 12


def test_plan_element_path():
    # rows that are not whole 16-byte vectors, or a misaligned base
    assert tpgn.plan(2, 42, 36, torch.bfloat16, 4).vec == 1
    assert tpgn.plan(2, 42, 36, torch.float32, 4).vec == 4
    assert tpgn.plan(2, 64, 320, torch.bfloat16, aligned=False).vec == 1
    # groups straddle the vectors at C/G = 3
    p = tpgn.plan(2, 200, 96, torch.bfloat16, 32)
    assert p.vec == 8 and 96 // 32 == 3


def test_plan_spreads_small_samples_thinly_not_below_a_floor():
    p = tpgn.plan(2, 200, 96, torch.bfloat16)
    assert p.cluster == 200 * 96 * 2 // tpgn.MIN_CTA_BYTES
    assert tpgn.plan(1, 1, 8, torch.bfloat16, 8).cluster == 1


def test_plan_refuses_what_no_layout_fits():
    with pytest.raises(ValueError, match="no layout"):
        tpgn.plan(1, 2, 40000, torch.float32, 20000)


def test_host_path_is_one_launch_with_params_in_their_dtype(monkeypatch):
    """The wrapper hands the kernel scale and bias in their own dtype (no
    cast), one output and the layout; the layout (and the card's
    occupancy) is worked out once per shape.  Run on CPU tensors with the
    launch and the occupancy replaced by recorders."""
    calls, asked = [], []

    def launch(x, scale, bias, y, layout):
        calls.append((x, scale, bias, y, layout))

    def occupancy(dtype, vec, silu, cs, threads, smem):
        asked.append(cs)
        return h100_like(cs, threads, smem)

    monkeypatch.setattr(_kernels, "group_norm", launch)
    monkeypatch.setattr(_kernels, "group_norm_max_clusters", occupancy)
    for cache in ("_plans", "_occupancy", "_launches"):
        monkeypatch.setattr(tpgn, cache, {})
    x = torch.zeros(8, 16, 16, 640, dtype=torch.bfloat16)
    w = torch.ones(640, dtype=torch.bfloat16)
    b = torch.zeros(640)
    y = tpgn._launch(x, w, b, 32, 1e-5, True)
    first = len(asked)
    assert 1 <= first == len(set(asked))  # each cluster size once
    y = tpgn._launch(x, w, b, 32, 1e-5, True)
    assert y.shape == x.shape and y.dtype == x.dtype and y.is_contiguous()
    assert len(calls) == 2 and len(asked) == first  # layout kept
    x1, scale, bias, y1, layout = calls[0]
    assert x1 is x and y1.shape == x.shape
    assert scale is w and bias is b  # bf16 and fp32 as given: no cast
    p = tpgn.plan(8, 256, 640, torch.bfloat16, 32, h100_like)
    got = {f: getattr(layout, f) for f, _ in layout._fields_}
    assert got == dict(n=8, hw=256, c=640, groups=32, cluster=p.cluster,
                       threads=p.threads, lanes=p.lanes, cv=p.cv,
                       resident=p.resident, vec=1, silu=1, dtype=0,
                       sdtype=0, bdtype=1, eps=pytest.approx(1e-5))
    with pytest.raises(ValueError, match="scale"):
        tpgn._launch(x, torch.ones(64), b, 32, 1e-5, True)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tpgn._launch(x.half(), w, b, 32, 1e-5, True)

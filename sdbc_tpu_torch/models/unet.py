"""UNet2DCondition — the SD-1.x, SD-2.x and SDXL denoisers (counterpart of
``sdbc_tpu/models/unet.py``).

conv_in(4→320); [cos|sin] time embedding → MLP → 1280; down blocks of two
ResBlocks (+ spatial transformer in the cross-attention blocks); mid
ResBlock/transformer/ResBlock; up blocks of three ResBlocks on the skip
connections; GroupNorm+SiLU head conv.  Activations are NHWC as in the JAX
package.  Parameter names follow the JAX tree (``down.0.attns.1.attn1.q.weight``).

The families: per-level head counts (``attention_heads`` a tuple, SD-2.x
and SDXL keep head dim 64), transformers of depth > 1 (SDXL's (–, 2, 10):
the JAX tree stacks their blocks under ``"blocks"`` with a leading depth
axis, here ``attns.<j>.blocks.<k>.…``; depth 1 keeps the flat layout) and
SDXL's text-time addition embedding (``add_mlp``, fed ``added_cond``).

``apply`` covers the forward with ``attn_impl`` set to "inference"
(sampling: the fixed-cap flash kernel and the fused GEGLU kernel on CUDA),
"auto" (training: differentiable, bf16 compute over fp32 masters; the
spatial self-attention takes the training flash kernels on CUDA, the
feed-forward stays unfused as in the JAX package) or the forced "xla",
"flash" and "flash_tt" of ``ops.attention``.  ``remat=True`` is gradient
checkpointing (the reference's enable_gradient_checkpointing):
``remat_mode="block"`` recomputes every ResBlock and spatial transformer in
the backward pass; "selective" recomputes the ResBlocks and, inside each
transformer, only the GroupNorm/proj-in, feed-forward and proj-out regions,
saving their matrix-product and convolution outputs (JAX's
``dots_saveable``) and leaving the attention calls and their projections
outside (the flash kernels keep O(S·D) residuals already); a depth > 1
transformer's blocks are each checkpointed whole, attention included,
with the feed-forward inside under the same policy.  Downsamplers,
upsamplers and conv_in/out are not checkpointed, as in the JAX package.
FreeU (``freeu``), the DeepCache trunk split (``return_deep``,
``cached_deep``, ``cache_tail``) and ControlNet's residuals
(``control_residuals``, ``models/controlnet.py``) are here.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn as tnn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from sdbc_tpu_torch.ops import geglu_ff as geglu_ff_mod
from sdbc_tpu_torch.ops import nn
from sdbc_tpu_torch.ops.attention import (IMPLS, attention,
                                          attention_bshd_inference)
from sdbc_tpu_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # an int: the same head count at every level (SD-1.x); a tuple: one
    # per level (SD-2.x and SDXL keep head dim 64)
    attention_heads: Union[int, Tuple[int, ...]] = 8
    norm_groups: int = 32
    cross_attn_blocks: Tuple[bool, ...] = (True, True, True, False)
    # transformer blocks per spatial transformer (diffusers
    # transformer_layers_per_block): an int, or one per level (SDXL
    # (1, 2, 10); levels without attention ignore theirs); the mid
    # transformer takes the deepest level's
    transformer_depth: Union[int, Tuple[int, ...]] = 1
    # SDXL's text-time addition embedding: ``apply`` then takes an
    # ``added_cond`` (N, addition_embed_dim) = pooled text ⧺ Fourier
    # features of the micro-conditioning ids, through its own 2-layer MLP
    addition_embed_dim: Optional[int] = None
    addition_time_embed_dim: int = 256

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def _per_level(self, value, name: str) -> Tuple[int, ...]:
        if isinstance(value, (tuple, list)):
            if len(value) != len(self.block_out_channels):
                raise ValueError(
                    f"{name} {value} must have one entry per block "
                    f"({len(self.block_out_channels)})")
            return tuple(value)
        return (value,) * len(self.block_out_channels)

    @property
    def heads_per_level(self) -> Tuple[int, ...]:
        return self._per_level(self.attention_heads, "attention_heads")

    @property
    def depth_per_level(self) -> Tuple[int, ...]:
        return self._per_level(self.transformer_depth, "transformer_depth")

    @staticmethod
    def sd15() -> "UNetConfig":
        return UNetConfig()

    @staticmethod
    def sd21() -> "UNetConfig":
        """SD-2.x: head dim 64 → (5, 10, 20, 20) heads over the SD-1.x
        widths; the OpenCLIP ViT-H context is 1024 wide."""
        return UNetConfig(cross_attention_dim=1024,
                          attention_heads=(5, 10, 20, 20))

    @staticmethod
    def sdxl() -> "UNetConfig":
        """SDXL base: 3 levels, no attention at full resolution, depth
        (–, 2, 10), (5, 10, 20) heads, a 2048-wide context (CLIP-L ⧺ bigG)
        and the text-time embedding (1280 pooled + 6 ids × 256 = 2816)."""
        return UNetConfig(block_out_channels=(320, 640, 1280),
                          cross_attention_dim=2048,
                          attention_heads=(5, 10, 20),
                          cross_attn_blocks=(False, True, True),
                          transformer_depth=(1, 2, 10),
                          addition_embed_dim=2816)

    @staticmethod
    def sdxl_refiner() -> "UNetConfig":
        """SDXL refiner: 4 levels, attention on the middle two, depth 4,
        (6, 12, 24, 24) heads, bigG's 1280-wide context alone and a
        text-time embedding of 1280 pooled + 5 ids × 256 = 2560."""
        return UNetConfig(block_out_channels=(384, 768, 1536, 1536),
                          cross_attention_dim=1280,
                          attention_heads=(6, 12, 24, 24),
                          cross_attn_blocks=(False, True, True, False),
                          transformer_depth=4,
                          addition_embed_dim=2560)

    @staticmethod
    def tiny() -> "UNetConfig":
        return UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                          cross_attention_dim=32, attention_heads=4,
                          norm_groups=8, cross_attn_blocks=(True, False))

    @staticmethod
    def tiny_xl() -> "UNetConfig":
        """SDXL's paths at toy size: a level without attention, depth-2
        transformers and the addition embedding (16 pooled + 6 × 4 = 40);
        context 64 = tiny CLIP-L 32 ⧺ tiny bigG 32."""
        return UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                          cross_attention_dim=64, attention_heads=4,
                          norm_groups=8, cross_attn_blocks=(False, True),
                          transformer_depth=(1, 2), addition_embed_dim=40,
                          addition_time_embed_dim=4)


# ---------------------------------------------------------------------------
# blocks


class ResBlock(tnn.Module):
    def __init__(self, cin, cout, temb_dim, **kw):
        super().__init__()
        self.norm1 = nn.GroupNorm(cin, **kw)
        self.conv1 = nn.Conv2d(cin, cout, 3, **kw)
        self.temb = nn.Linear(temb_dim, cout, **kw)
        self.norm2 = nn.GroupNorm(cout, **kw)
        self.conv2 = nn.Conv2d(cout, cout, 3, **kw)
        self.shortcut = nn.Conv2d(cin, cout, 1, **kw) if cin != cout else None

    def forward(self, x, temb, groups, tproj=None):
        # tensor parallelism (``parallel.shard``): conv1/temb hold this
        # rank's output channels, norm2 their groups, conv2 the matching
        # input rows; its partial sums are all-reduced before the bias
        tp = getattr(self, "tp", None)
        # UNet norm eps 1e-5 (the transformer GroupNorm keeps 1e-6)
        h = self.norm1(x, groups, eps=1e-5, act="silu")
        if tp is not None:
            h = comm.copy_to(h, tp)
        h = self.conv1(h)
        if tproj is None:
            st = F.silu(temb)
            if tp is not None:
                st = comm.copy_to(st, tp)
            tproj = self.temb(st)[:, None, None, :]
        h = h + tproj.to(h.dtype)
        h = self.norm2(h, groups if tp is None else groups // tp.size,
                       eps=1e-5, act="silu")
        if tp is None:
            h = self.conv2(h)
        else:
            h = comm.reduce_from(nn.conv2d(h, self.conv2.weight), tp) \
                + self.conv2.bias.to(h.dtype)
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class MHA(tnn.Module):
    def __init__(self, dim, kv_dim, **kw):
        super().__init__()
        self.q = nn.Linear(dim, dim, use_bias=False, **kw)
        self.k = nn.Linear(kv_dim, dim, use_bias=False, **kw)
        self.v = nn.Linear(kv_dim, dim, use_bias=False, **kw)
        self.o = nn.Linear(dim, dim, **kw)

    def forward(self, x, ctx, heads, impl="auto"):
        # tensor parallelism: q/k/v hold this rank's heads (columns), o
        # the matching rows; the partial products are all-reduced before
        # o's bias
        tp = getattr(self, "tp", None)
        if tp is not None:
            same = ctx is x
            x = comm.copy_to(x, tp)
            ctx = x if same else comm.copy_to(ctx, tp)
            heads //= tp.size
        b, s, dim = x.shape
        hd = dim // heads if tp is None else dim // (heads * tp.size)
        dim = heads * hd                 # this rank's heads × head dim
        if impl == "inference":
            # projection layout (b, s, h, d): the kernel reads the heads
            # through its strides, no head split/merge copies
            q4 = self.q(x).reshape(b, -1, heads, hd)
            k4 = self.k(ctx).reshape(b, -1, heads, hd)
            v4 = self.v(ctx).reshape(b, -1, heads, hd)
            a = attention_bshd_inference(q4, k4, v4).reshape(b, s, dim)
        else:
            def split(t):
                return t.reshape(b, -1, heads, hd).transpose(1, 2)

            a = attention(split(self.q(x)), split(self.k(ctx)),
                          split(self.v(ctx)), impl=impl)
            a = a.transpose(1, 2).reshape(b, s, dim)
        if tp is None:
            return self.o(a)
        return comm.reduce_from(nn.linear(a, self.o.weight), tp) \
            + self.o.bias.to(a.dtype)


def _block_modules(m: tnn.Module, dim, ctx_dim, **kw) -> None:
    """The modules of one pre-LN transformer block, set on ``m``:
    self-attention → cross-attention → GEGLU feed-forward."""
    m.ln1 = nn.LayerNorm(dim, **kw)
    m.attn1 = MHA(dim, dim, **kw)
    m.ln2 = nn.LayerNorm(dim, **kw)
    m.attn2 = MHA(dim, ctx_dim, **kw)
    m.ln3 = nn.LayerNorm(dim, **kw)
    m.geglu = nn.Linear(dim, 8 * dim, **kw)
    m.ff_out = nn.Linear(4 * dim, dim, **kw)


class _BasicBlock(tnn.Module):
    """One block of a depth > 1 transformer (``blocks.<k>``)."""

    def __init__(self, dim, ctx_dim, **kw):
        super().__init__()
        _block_modules(self, dim, ctx_dim, **kw)


def _attend(p, y, ctx, heads, attn_impl):
    yn = p.ln1(y)
    y = y + p.attn1(yn, yn, heads, attn_impl)
    return y + p.attn2(p.ln2(y), ctx, heads, attn_impl)


def _ff(p, y):
    tp = getattr(p, "ff_tp", None)
    if tp is None:
        z = p.geglu(p.ln3(y))
        val, gate = z.chunk(2, dim=-1)
        return y + p.ff_out(val * F.gelu(gate))
    # tensor parallelism: the up-projection holds this rank's rows (the
    # contraction), so the sum over ranks comes BEFORE the bias and the
    # gate; ff_out holds this rank's output columns, and the block's
    # output leaves channel-sharded (``Transformer`` gathers it or hands
    # it to the row-sharded proj_out)
    yn = comm.scatter_to(p.ln3(y), tp)
    z = comm.reduce_from(torch.matmul(yn, p.geglu.weight.to(yn.dtype)), tp) \
        + p.geglu.bias.to(yn.dtype)
    val, gate = z.chunk(2, dim=-1)
    h = comm.copy_to(val * F.gelu(gate), tp)
    return comm.scatter_to(y, tp) + p.ff_out(h)


def _basic_block(p, y, ctx, heads, attn_impl):
    y = _attend(p, y, ctx, heads, attn_impl)
    # the fused kernel needs the whole up-projection before its gate: under
    # tensor parallelism the unfused FF runs, as in the JAX package
    if attn_impl == "inference" and getattr(p, "ff_tp", None) is None \
            and geglu_ff_mod.ff_fused_eligible(y):
        # LN → up-proj → GELU gate → down-proj → residual in one kernel
        return geglu_ff_mod.geglu_ff(y, p.ln3, p.geglu, p.ff_out)
    return _ff(p, y)


class Transformer(tnn.Module):
    """Spatial transformer: GroupNorm → proj_in → ``depth`` basic blocks →
    proj_out + residual.  Depth 1 (SD-1.x/2.x) keeps the JAX package's
    flat layout (the block's modules on the transformer itself); depth > 1
    holds them in ``blocks``."""

    def __init__(self, dim, ctx_dim, heads: int, depth: int = 1, **kw):
        super().__init__()
        self.heads = heads
        self.depth = depth
        self.norm = nn.GroupNorm(dim, **kw)
        self.proj_in = nn.Conv2d(dim, dim, 1, **kw)
        if depth == 1:
            _block_modules(self, dim, ctx_dim, **kw)
        else:
            self.blocks = tnn.ModuleList(_BasicBlock(dim, ctx_dim, **kw)
                                         for _ in range(depth))
        self.proj_out = nn.Conv2d(dim, dim, 1, **kw)

    def tfm_in(self, x, groups):
        n, h, w, c = x.shape
        y = self.norm(x, groups, eps=1e-6)
        return self.proj_in(y).reshape(n, h * w, c)

    def _ff_tp(self):
        blk = self.blocks[0] if self.depth > 1 else self
        return getattr(blk, "ff_tp", None)

    def _between(self, y, k: int):
        """Block ``k``'s output for the next block: under tensor
        parallelism the channel-sharded output gathered."""
        tp = self._ff_tp()
        return y if tp is None or k == self.depth - 1 \
            else comm.gather_from(y, tp)

    def tfm_out(self, y, x):
        tp, ptp = self._ff_tp(), getattr(self, "proj_tp", None)
        if tp is not None and ptp is None:
            y = comm.gather_from(y, tp)
        y = y.reshape(*x.shape[:-1], y.shape[-1])
        if ptp is None:
            return self.proj_out(y) + x
        # row-sharded proj_out on the channel-sharded block output
        return comm.reduce_from(nn.conv2d(y, self.proj_out.weight), ptp) \
            + self.proj_out.bias.to(y.dtype) + x

    def forward(self, x, ctx, groups, attn_impl="auto"):
        y = self.tfm_in(x, groups)
        for k, blk in enumerate(self.blocks if self.depth > 1 else (self,)):
            y = self._between(_basic_block(blk, y, ctx, self.heads,
                                           attn_impl), k)
        return self.tfm_out(y, x)

    def forward_selective(self, x, ctx, groups, attn_impl="auto"):
        """``forward`` under ``remat_mode="selective"`` (the JAX package's
        ``_transformer_selective``): the same ops in the same order.  At
        depth 1 the attention stays outside the checkpoint regions; a
        deeper transformer checkpoints each block whole, its attention
        included, with the feed-forward inside under the dots policy (the
        JAX package's ``jax.checkpoint(block)`` in the scan)."""
        y = _checkpoint_dots(self.tfm_in, x, groups)
        if self.depth == 1:
            y = _selective_block(self, y, ctx, self.heads, attn_impl)
        else:
            for k, blk in enumerate(self.blocks):
                y = self._between(_checkpoint(
                    _selective_block, blk, y, ctx, self.heads, attn_impl), k)
        return _checkpoint_dots(self.tfm_out, y, x)


def _selective_block(p, y, ctx, heads, attn_impl):
    """One block under the selective policy: attention as it is, the
    feed-forward checkpointed with its matrix products saved."""
    y = _attend(p, y, ctx, heads, attn_impl)
    return _checkpoint_dots(_ff, p, y)


class _Block(tnn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = tnn.ModuleList()
        self.attns = tnn.ModuleList()


class _Mid(tnn.Module):
    def __init__(self, ch, ctx_dim, ted, heads, depth, **kw):
        super().__init__()
        self.resnet1 = ResBlock(ch, ch, ted, **kw)
        self.attn = Transformer(ch, ctx_dim, heads, depth, **kw)
        self.resnet2 = ResBlock(ch, ch, ted, **kw)


class _TimeMLP(tnn.Module):
    def __init__(self, c0, ted, **kw):
        super().__init__()
        self.fc1 = nn.Linear(c0, ted, **kw)
        self.fc2 = nn.Linear(ted, ted, **kw)


def skip_channels(cfg: UNetConfig) -> list:
    """The channels of every skip tensor of the down path, in append
    order: conv_in's, one per down-block ResBlock, one per downsample."""
    ch = cfg.block_out_channels
    out = [ch[0]]
    for i, cout in enumerate(ch):
        out += [cout] * cfg.layers_per_block
        if i < len(ch) - 1:
            out.append(cout)
    return out


def down_blocks(cfg: UNetConfig, **kw):
    """(the down blocks of ``cfg``, their skip channels): ResBlocks (with
    a spatial transformer at the cross-attention levels) and a stride-2
    downsample below the deepest level.  Shared by the UNet and the
    ControlNet branch, whose encoder half is the UNet's."""
    ch, ted = cfg.block_out_channels, cfg.time_embed_dim
    heads, depths = cfg.heads_per_level, cfg.depth_per_level
    down = tnn.ModuleList()
    cin = ch[0]
    for i, cout in enumerate(ch):
        blk = _Block()
        for j in range(cfg.layers_per_block):
            blk.resnets.append(ResBlock(cin if j == 0 else cout, cout, ted,
                                        **kw))
            if cfg.cross_attn_blocks[i]:
                blk.attns.append(Transformer(
                    cout, cfg.cross_attention_dim, heads[i], depths[i],
                    **kw))
        if i < len(ch) - 1:
            blk.downsample = nn.Conv2d(cout, cout, 3, **kw)
        down.append(blk)
        cin = cout
    return down, skip_channels(cfg)


class UNet(tnn.Module):
    def __init__(self, cfg: UNetConfig, *, device, generator=None,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, generator=generator, dtype=dtype)
        self.cfg = cfg
        ch = cfg.block_out_channels
        ted = cfg.time_embed_dim
        heads, depths = cfg.heads_per_level, cfg.depth_per_level
        # construction order = the JAX init's key order (not its stream)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, **kw)
        self.time_mlp = _TimeMLP(ch[0], ted, **kw)
        if cfg.addition_embed_dim:
            # SDXL's text-time embedding (diffusers add_embedding)
            self.add_mlp = _TimeMLP(cfg.addition_embed_dim, ted, **kw)
        self.down, skip_ch = down_blocks(cfg, **kw)
        self.mid = _Mid(ch[-1], cfg.cross_attention_dim, ted, heads[-1],
                        depths[-1], **kw)
        self.up = tnn.ModuleList()
        rev_cross = list(reversed(cfg.cross_attn_blocks))
        prev = ch[-1]
        for i, cout in enumerate(reversed(ch)):
            lvl = len(ch) - 1 - i
            blk = _Block()
            for _ in range(cfg.layers_per_block + 1):
                skip = skip_ch.pop()
                blk.resnets.append(ResBlock(prev + skip, cout, ted, **kw))
                if rev_cross[i]:
                    blk.attns.append(Transformer(
                        cout, cfg.cross_attention_dim, heads[lvl],
                        depths[lvl], **kw))
                prev = cout
            if i < len(ch) - 1:
                blk.upsample = nn.Conv2d(cout, cout, 3, **kw)
            self.up.append(blk)
        self.norm_out = nn.GroupNorm(ch[0], **kw)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, **kw)


def init(cfg: UNetConfig, *, device, generator=None,
         dtype=torch.float32) -> UNet:
    return UNet(cfg, device=device, generator=generator, dtype=dtype)


# ---------------------------------------------------------------------------
# time-embedding hoist


def _temb_mlp(model, timesteps, dtype):
    """The time embedding of a UNet or a ControlNet branch (its UNet
    config under ``cfg.unet``)."""
    c0 = getattr(model.cfg, "unet", model.cfg).block_out_channels[0]
    temb = nn.timestep_embedding(timesteps, c0, dtype=dtype)
    return model.time_mlp.fc2(F.silu(model.time_mlp.fc1(temb)))


def _add_embedding(model, added_cond):
    """The text-time embedding of ``added_cond`` (N, addition_embed_dim),
    in fp32 as the JAX package computes it."""
    mlp = model.add_mlp
    return mlp.fc2(F.silu(mlp.fc1(added_cond.float())))


def _check_added_cond(cfg: UNetConfig, added_cond, where: str) -> None:
    if (added_cond is None) != (not cfg.addition_embed_dim):
        raise ValueError(
            f"{where}: added_cond must be passed exactly when "
            f"cfg.addition_embed_dim is set (got added_cond="
            f"{'None' if added_cond is None else 'set'}, addition_embed_dim="
            f"{cfg.addition_embed_dim})")


def precompute_temb(model: UNet, timesteps, dtype=torch.bfloat16,
                    added_cond=None):
    """Every ResBlock's time projection for a whole timestep grid.

    timesteps: (T,) → a tree mirroring the ResBlock nesting with (T, cout)
    tables; ``index_temb(tree, i)`` slices step i.  Same math as the inline
    path, evaluated once per grid instead of once per step.

    ``added_cond`` (SDXL; required exactly when ``addition_embed_dim`` is
    set): the (N, addition_embed_dim) conditioning of the UNet batch (the
    uncond ⧺ cond stack under CFG).  The embedding is then per sample, and
    the tables are (T, N, 1, 1, cout): step i's slice broadcasts over the
    (N, H, W, cout) activation."""
    _check_added_cond(model.cfg, added_cond, "precompute_temb")
    temb = _temb_mlp(model, timesteps, dtype)
    if added_cond is not None:
        aug = _add_embedding(model, added_cond)
        temb = temb[:, None, :] + aug[None].to(temb.dtype)  # (T, N, ted)
    st = F.silu(temb)

    def proj(r):
        out = r.temb(st)
        return out if added_cond is None else out[:, :, None, None]

    return {"down": [{"resnets": [proj(r) for r in blk.resnets]}
                     for blk in model.down],
            "mid": {"resnet1": proj(model.mid.resnet1),
                    "resnet2": proj(model.mid.resnet2)},
            "up": [{"resnets": [proj(r) for r in blk.resnets]}
                   for blk in model.up]}


def index_temb(temb_proj, i):
    """Slice step ``i``'s (cout,) vectors (per-sample tables: its (N, 1, 1,
    cout) rows) out of a ``precompute_temb`` tree."""
    return map_temb(lambda t: t[i], temb_proj)


def map_temb(fn, temb_proj):
    """``fn`` applied to every table of a ``precompute_temb`` tree."""
    if isinstance(temb_proj, dict):
        return {k: map_temb(fn, v) for k, v in temb_proj.items()}
    if isinstance(temb_proj, list):
        return [map_temb(fn, v) for v in temb_proj]
    return fn(temb_proj)


# ---------------------------------------------------------------------------
# gradient checkpointing

# JAX's dots_saveable: matrix products and convolutions keep their outputs
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              torch.ops.aten.bmm.default, torch.ops.aten.convolution.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint_dots(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          _dots_saveable))


def _checkpoint(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# FreeU (Si et al. 2023, arXiv:2309.11497): at sampling time, amplify the
# backbone's low-channel half and damp the skip connections' low-frequency
# band at the two deepest decoder stages.


def fourier_filter(x, threshold: int, scale):
    """Scale the centred low-frequency box of a (N, H, W, C) feature map:
    FFT over the spatial axes, fftshift, multiply the (2·threshold)² centre
    box by ``scale``, invert (fp32 inside, x's dtype out)."""
    dtype = x.dtype
    xf = torch.fft.fftn(x.float(), dim=(1, 2))
    xf = torch.fft.fftshift(xf, dim=(1, 2))
    h, w = x.shape[1], x.shape[2]
    crow, ccol = h // 2, w // 2
    mask = torch.ones((h, w), dtype=torch.float32, device=x.device)
    mask[max(crow - threshold, 0):crow + threshold,
         max(ccol - threshold, 0):ccol + threshold] = float(scale)
    xf = xf * mask[None, :, :, None]
    xf = torch.fft.ifftshift(xf, dim=(1, 2))
    return torch.fft.ifftn(xf, dim=(1, 2)).real.to(dtype)


def _apply_freeu(h, skip, b_scale: float, s_scale: float):
    """One FreeU modification before a decoder concat: the first half of
    the backbone channels times ``b`` (rounded to h's dtype first, as the
    JAX package multiplies), the skip low-pass-scaled by ``s``.  Scales of
    exactly 1.0 are skipped, so (1, 1, 1, 1) gives the bits of no FreeU."""
    if b_scale != 1.0:
        half = h.shape[-1] // 2
        b = float(torch.tensor(b_scale, dtype=h.dtype))
        h = torch.cat([h[..., :half] * b, h[..., half:]], dim=-1)
    if s_scale != 1.0:
        skip = fourier_filter(skip, 1, s_scale)
    return h, skip


# recommended settings of the FreeU paper / reference implementation
FREEU_SD15 = (1.5, 1.6, 0.9, 0.2)   # (b1, b2, s1, s2)
FREEU_SD21 = (1.4, 1.6, 0.9, 0.2)
FREEU_SDXL = (1.3, 1.4, 0.9, 0.2)


# ---------------------------------------------------------------------------
# apply


def apply(model: UNet, latents, timesteps, encoder_hidden_states, *,
          attn_impl: str = "auto", temb_proj=None, remat: bool = False,
          remat_mode: str = "block", cached_deep=None,
          return_deep: bool = False, cache_tail: int = 0, freeu=None,
          added_cond=None, control_residuals=None):
    """latents (N,h,w,4), timesteps (N,), CLIP states (N,77,768) → eps (N,h,w,4).

    ``temb_proj``: this step's slice of a ``precompute_temb`` tree, or None
    to embed ``timesteps`` inline.  ``attn_impl``: one of
    ``ops.attention.IMPLS``.  ``remat``/``remat_mode``: gradient
    checkpointing, "block" or "selective" (module docstring).

    DeepCache trunk caching (the JAX package's split): ``return_deep=True``
    also returns the deep trunk's output, ``cached_deep=<that tensor>``
    skips the trunk.  ``cache_tail`` sets the boundary: how many trailing
    ResBlocks of the last up block run fresh on cached steps (0 = all of
    them, plus the whole first down block; 1 = only conv_in, the last
    ResBlock and the head).  The uncached forward is the same ops in the
    same order for every ``cache_tail``.

    ``freeu``: optional (b1, b2, s1, s2) — before each skip concat of up
    blocks 0 and 1, the backbone's first half channels scale by b and the
    skip's low-frequency band by s (``fourier_filter``).  Presets
    ``FREEU_SD15/SD21/SDXL``.

    ``added_cond``: SDXL's (N, addition_embed_dim) text-time conditioning,
    required exactly when the config sets ``addition_embed_dim`` and no
    ``temb_proj`` is given (the hoisted tables hold it already), run
    through ``add_mlp`` and added to the time embedding.

    ``control_residuals``: (down residuals, mid residual) of
    ``controlnet.apply`` (the JAX package's ``unet.py:734-857``).  Each
    down residual is added to the skip tensor it indexes when that skip is
    saved, not to the activation that flows on; the mid residual to the
    mid block's output.  Refused with the DeepCache split (the residuals
    land inside the cached trunk)."""
    if attn_impl not in IMPLS:
        raise ValueError(f"unknown attention impl {attn_impl!r}")
    if remat_mode not in ("block", "selective"):
        raise ValueError(f"unknown remat_mode {remat_mode!r}")
    cfg = model.cfg
    if temb_proj is None:
        _check_added_cond(cfg, added_cond, "apply")
    elif added_cond is not None:
        raise ValueError("added_cond is already in the temb_proj tables "
                         "(precompute_temb added_cond): pass only one")
    if control_residuals is not None:
        if cached_deep is not None or return_deep:
            raise ValueError("control_residuals cannot combine with "
                             "DeepCache trunk caching (the residuals land "
                             "inside the trunk)")
        want = len(skip_channels(cfg))
        if len(control_residuals[0]) != want:
            raise ValueError(
                f"control_residuals: {len(control_residuals[0])} down "
                f"residuals for {want} skip tensors (the ControlNet and "
                "UNet configs disagree)")
    g = cfg.norm_groups
    ctx = encoder_hidden_states

    if temb_proj is None:
        temb = _temb_mlp(model, timesteps, latents.dtype)
        if added_cond is not None:
            temb = temb + _add_embedding(model, added_cond).to(temb.dtype)
        tp_down = [{"resnets": [None] * len(b.resnets)} for b in model.down]
        tp_mid = {"resnet1": None, "resnet2": None}
        tp_up = [{"resnets": [None] * len(b.resnets)} for b in model.up]
    else:
        temb = None
        tp_down, tp_mid, tp_up = (temb_proj["down"], temb_proj["mid"],
                                  temb_proj["up"])

    def res(r, h, tp):
        if remat:
            return _checkpoint(r, h, temb, g, tp)
        return r(h, temb, g, tp)

    def tfm(t, h):
        if remat and remat_mode == "selective":
            return t.forward_selective(h, ctx, g, attn_impl)
        if remat:
            return _checkpoint(t, h, ctx, g, attn_impl)
        return t(h, ctx, g, attn_impl)

    # the skips' running index: the append order (conv_in, each down
    # ResBlock, each downsample) is the residuals' order on every branch
    # of the DeepCache split
    n_saved = [0]

    def save(skips, h):
        if control_residuals is not None:
            h = h + control_residuals[0][n_saved[0]].to(h.dtype)
            n_saved[0] += 1
        skips.append(h)

    def resnet_j(blk, tp, j, h, skips=None):
        h = res(blk.resnets[j], h, tp["resnets"][j])
        if len(blk.attns):
            h = tfm(blk.attns[j], h)
        if skips is not None:
            save(skips, h)
        return h

    def block_down(blk, tp, h, skips, first=0):
        for j in range(first, len(blk.resnets)):
            h = resnet_j(blk, tp, j, h, skips)
        if hasattr(blk, "downsample"):
            h = blk.downsample(h, stride=2, padding=1)
            save(skips, h)
        return h

    def block_up(blk, tp, h, skips, fu=None, js=None):
        for j in (range(len(blk.resnets)) if js is None else js):
            skip = skips.pop()
            if fu is not None:
                h, skip = _apply_freeu(h, skip, *fu)
            h = resnet_j(blk, tp, j, torch.cat([h, skip], dim=-1))
        if js is None and hasattr(blk, "upsample"):
            h = nn.upsample_nearest_2x(h)
            h = blk.upsample(h)
        return h

    blk0, last_up = model.down[0], model.up[-1]
    total_tail = len(last_up.resnets)
    ct = cache_tail if cache_tail and 0 < cache_tail <= total_tail \
        else total_tail
    head_resnets = ct - 1  # down[0] resnets whose skips the fresh tail pops

    # shallow head: conv_in + the first (ct-1) resnets of down[0]
    h = model.conv_in(latents)
    shallow_skips = []
    save(shallow_skips, h)
    for j in range(head_resnets):
        h = resnet_j(blk0, tp_down[0], j, h, shallow_skips)

    if cached_deep is None:
        deep_skips = []
        d = block_down(blk0, tp_down[0], h, deep_skips, first=head_resnets)
        for blk, tp in zip(model.down[1:], tp_down[1:]):
            d = block_down(blk, tp, d, deep_skips)
        d = res(model.mid.resnet1, d, tp_mid["resnet1"])
        d = tfm(model.mid.attn, d)
        d = res(model.mid.resnet2, d, tp_mid["resnet2"])
        if control_residuals is not None:
            d = d + control_residuals[1].to(d.dtype)
        for i, (blk, tp) in enumerate(zip(model.up[:-1], tp_up[:-1])):
            fu = None
            if freeu is not None and i < 2:
                fu = (freeu[0], freeu[2]) if i == 0 else (freeu[1], freeu[3])
            d = block_up(blk, tp, d, deep_skips, fu)
        # deep-owned leading resnets of the last up block
        deep = block_up(last_up, tp_up[-1], d, deep_skips,
                        js=range(total_tail - ct))
    else:
        deep = cached_deep

    h = block_up(last_up, tp_up[-1], deep, shallow_skips,
                 js=range(total_tail - ct, total_tail))
    h = model.norm_out(h, g, eps=1e-5, act="silu")
    out = model.conv_out(h)
    return (out, deep) if return_deep else out

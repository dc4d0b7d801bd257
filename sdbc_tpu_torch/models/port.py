"""Diffusers SD-1.x checkpoints and the pytorch-fid Inception weights into
the port (counterpart of the SD-1.x and FID parts of
``sdbc_tpu/models/port.py``).

Each ``port_*`` returns the JAX package's nested numpy parameter tree, the
carrier of weights across the two packages: ``models.convert.
load_jax_params`` (``SDPipeline`` does it for a ``{"text_encoder", "unet",
"vae"}`` dict) and ``models.inception.from_tree`` build the modules.

Conventions (the JAX module's):
  - torch conv (O, I, H, W) → HWIO (H, W, I, O); torch linear (O, I) →
    (I, O); every leaf float32;
  - CLIP's per-layer parameters stacked along a leading layer axis.

Sources: ``.safetensors`` through ``read_safetensors`` (a reader of the
format written here: the ``safetensors`` package is not needed), ``.bin``
and ``.pth`` through ``torch.load(weights_only=True)``.  Layouts of the
families the port has not taken (SDXL's second encoder and text-time
embedding, SD-2's per-block heads, depth > 1 transformers) raise
``NotImplementedError``; ControlNet, BART, the safety checker and the
exporters wait (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np

# ---------------------------------------------------------------------------
# state-dict loading

_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file as {name: array}: an 8-byte little-endian
    header length, a JSON header (dtype, shape, byte offsets into the data
    that follows), then the raw little-endian buffers.  BF16 tensors are
    widened to float32 exactly (numpy has no bfloat16); the others keep
    their dtype."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        raw = data[lo:hi]
        dt, shape = info["dtype"], tuple(info["shape"])
        if dt == "BF16":
            bits = raw.view("<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif dt in _ST_DTYPES:
            arr = np.array(raw.view(np.dtype(_ST_DTYPES[dt]).newbyteorder(
                "<")), dtype=_ST_DTYPES[dt])
        else:
            raise ValueError(f"{path}: tensor {name} has dtype {dt}, which "
                             "this reader does not take")
        out[name] = arr.reshape(shape)
    return out


def load_state_dict(component_dir: str) -> Dict[str, np.ndarray]:
    """Load a diffusers/transformers component dir into {name: np.ndarray}."""
    cands = [f for f in sorted(os.listdir(component_dir))
             if f.endswith((".safetensors", ".bin"))]
    if not cands:
        raise FileNotFoundError(f"no weight files in {component_dir}")
    # HF dirs often ship BOTH formats with identical content: prefer
    # safetensors alone (no double load)
    if any(f.endswith(".safetensors") for f in cands):
        cands = [f for f in cands if f.endswith(".safetensors")]
    out: Dict[str, np.ndarray] = {}
    for fname in cands:
        path = os.path.join(component_dir, fname)
        if fname.endswith(".safetensors"):
            out.update(read_safetensors(path))
        else:
            out.update(_torch_load(path))
    return out


def _torch_load(path: str) -> Dict[str, np.ndarray]:
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32))


def _conv(sd, name):
    p = {"w": _f32(np.transpose(sd[f"{name}.weight"], (2, 3, 1, 0)))}
    if f"{name}.bias" in sd:
        p["b"] = _f32(sd[f"{name}.bias"])
    return p


def _linear(sd, name):
    p = {"w": _f32(np.transpose(sd[f"{name}.weight"], (1, 0)))}
    if f"{name}.bias" in sd:
        p["b"] = _f32(sd[f"{name}.bias"])
    return p


def _norm(sd, name):
    return {"scale": _f32(sd[f"{name}.weight"]),
            "bias": _f32(sd[f"{name}.bias"])}


def _stack(trees):
    """Stack a list of identically shaped trees leaf by leaf."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


# ---------------------------------------------------------------------------
# UNet


def _port_resnet(sd, pfx):
    p = {
        "norm1": _norm(sd, f"{pfx}.norm1"),
        "conv1": _conv(sd, f"{pfx}.conv1"),
        "norm2": _norm(sd, f"{pfx}.norm2"),
        "conv2": _conv(sd, f"{pfx}.conv2"),
    }
    if f"{pfx}.time_emb_proj.weight" in sd:
        p["temb"] = _linear(sd, f"{pfx}.time_emb_proj")
    if f"{pfx}.conv_shortcut.weight" in sd:
        p["shortcut"] = _conv(sd, f"{pfx}.conv_shortcut")
    return p


def _proj_conv(sd, name):
    """Spatial-transformer proj_in/proj_out → the 1×1-conv layout (a 2-D
    linear weight, ``use_linear_projection``, is the same per-pixel map)."""
    w = sd[f"{name}.weight"]
    if w.ndim == 2:
        p = {"w": _f32(np.transpose(w, (1, 0))[None, None])}
        if f"{name}.bias" in sd:
            p["b"] = _f32(sd[f"{name}.bias"])
        return p
    return _conv(sd, name)


def _port_transformer(sd, pfx):
    if f"{pfx}.transformer_blocks.1.norm1.weight" in sd:
        raise NotImplementedError(
            f"{pfx}: depth > 1 transformer blocks (SDXL) are not ported "
            "yet (ROADMAP Queue 1 item 9)")
    tb = f"{pfx}.transformer_blocks.0"
    attn = lambda a: {"q": _linear(sd, f"{tb}.{a}.to_q"),
                      "k": _linear(sd, f"{tb}.{a}.to_k"),
                      "v": _linear(sd, f"{tb}.{a}.to_v"),
                      "o": _linear(sd, f"{tb}.{a}.to_out.0")}
    return {
        "norm": _norm(sd, f"{pfx}.norm"),
        "proj_in": _proj_conv(sd, f"{pfx}.proj_in"),
        "proj_out": _proj_conv(sd, f"{pfx}.proj_out"),
        "ln1": _norm(sd, f"{tb}.norm1"),
        "attn1": attn("attn1"),
        "ln2": _norm(sd, f"{tb}.norm2"),
        "attn2": attn("attn2"),
        "ln3": _norm(sd, f"{tb}.norm3"),
        "geglu": _linear(sd, f"{tb}.ff.net.0.proj"),
        "ff_out": _linear(sd, f"{tb}.ff.net.2"),
    }


def port_unet(sd: Dict[str, np.ndarray]) -> dict:
    """diffusers UNet2DConditionModel state dict (SD-1.x) → the UNet tree."""
    if "time_embedding.cond_proj.weight" in sd:
        raise ValueError(
            "UNet weights carry time_embedding.cond_proj (fully-distilled "
            "LCM/guidance-embedded checkpoint); unsupported — use LCM-LoRA "
            "weights merged onto a standard UNet instead")
    if "add_embedding.linear_1.weight" in sd:
        raise NotImplementedError("the SDXL text-time embedding "
                                  "(add_embedding) is not ported yet "
                                  "(ROADMAP Queue 1 item 9)")
    p = {
        "conv_in": _conv(sd, "conv_in"),
        "time_mlp": {
            "fc1": _linear(sd, "time_embedding.linear_1"),
            "fc2": _linear(sd, "time_embedding.linear_2"),
        },
        "norm_out": _norm(sd, "conv_norm_out"),
        "conv_out": _conv(sd, "conv_out"),
    }

    def block(prefix):
        blk = {"resnets": [], "attns": []}
        j = 0
        while f"{prefix}.resnets.{j}.norm1.weight" in sd:
            blk["resnets"].append(_port_resnet(sd, f"{prefix}.resnets.{j}"))
            if f"{prefix}.attentions.{j}.proj_in.weight" in sd:
                blk["attns"].append(
                    _port_transformer(sd, f"{prefix}.attentions.{j}"))
            j += 1
        if f"{prefix}.downsamplers.0.conv.weight" in sd:
            blk["downsample"] = _conv(sd, f"{prefix}.downsamplers.0.conv")
        if f"{prefix}.upsamplers.0.conv.weight" in sd:
            blk["upsample"] = _conv(sd, f"{prefix}.upsamplers.0.conv")
        return blk

    for side, key in (("down", "down_blocks"), ("up", "up_blocks")):
        p[side] = []
        i = 0
        while f"{key}.{i}.resnets.0.norm1.weight" in sd:
            p[side].append(block(f"{key}.{i}"))
            i += 1
    p["mid"] = {
        "resnet1": _port_resnet(sd, "mid_block.resnets.0"),
        "attn": _port_transformer(sd, "mid_block.attentions.0"),
        "resnet2": _port_resnet(sd, "mid_block.resnets.1"),
    }
    return p


# ---------------------------------------------------------------------------
# VAE


def _port_vae_attn(sd, pfx):
    """Handles both old (query/key/value/proj_attn) and new (to_q/...) names."""
    if f"{pfx}.to_q.weight" in sd:
        names = ("to_q", "to_k", "to_v", "to_out.0")
    else:
        names = ("query", "key", "value", "proj_attn")
    group_norm = "group_norm" if f"{pfx}.group_norm.weight" in sd else "norm"
    return {
        "norm": _norm(sd, f"{pfx}.{group_norm}"),
        "q": _linear(sd, f"{pfx}.{names[0]}"),
        "k": _linear(sd, f"{pfx}.{names[1]}"),
        "v": _linear(sd, f"{pfx}.{names[2]}"),
        "o": _linear(sd, f"{pfx}.{names[3]}"),
    }


def port_vae(sd: Dict[str, np.ndarray]) -> dict:
    """diffusers AutoencoderKL state dict → the VAE tree."""
    def coder(side, blocks_key, updown):
        c = {
            "conv_in": _conv(sd, f"{side}.conv_in"),
            "mid": {
                "resnet1": _port_resnet(sd, f"{side}.mid_block.resnets.0"),
                "attn": _port_vae_attn(sd, f"{side}.mid_block.attentions.0"),
                "resnet2": _port_resnet(sd, f"{side}.mid_block.resnets.1"),
            },
            "norm_out": _norm(sd, f"{side}.conv_norm_out"),
            "conv_out": _conv(sd, f"{side}.conv_out"),
        }
        blocks = []
        i = 0
        while f"{side}.{blocks_key}.{i}.resnets.0.norm1.weight" in sd:
            pfx = f"{side}.{blocks_key}.{i}"
            blk = {"resnets": []}
            j = 0
            while f"{pfx}.resnets.{j}.norm1.weight" in sd:
                blk["resnets"].append(_port_resnet(sd, f"{pfx}.resnets.{j}"))
                j += 1
            if f"{pfx}.downsamplers.0.conv.weight" in sd:
                blk["downsample"] = _conv(sd, f"{pfx}.downsamplers.0.conv")
            if f"{pfx}.upsamplers.0.conv.weight" in sd:
                blk["upsample"] = _conv(sd, f"{pfx}.upsamplers.0.conv")
            blocks.append(blk)
            i += 1
        c[updown] = blocks
        return c

    return {
        "encoder": coder("encoder", "down_blocks", "down"),
        "decoder": coder("decoder", "up_blocks", "up"),
        "quant_conv": _conv(sd, "quant_conv"),
        "post_quant_conv": _conv(sd, "post_quant_conv"),
    }


# ---------------------------------------------------------------------------
# CLIP text encoder


def port_clip_text(sd: Dict[str, np.ndarray]) -> dict:
    """transformers CLIPTextModel state dict → the text-encoder tree."""
    if "text_projection.weight" in sd:
        raise NotImplementedError("CLIPTextModelWithProjection (SDXL's "
                                  "text_encoder_2) is not ported yet "
                                  "(ROADMAP Queue 1 item 9)")
    pfx = "text_model." if "text_model.final_layer_norm.weight" in sd else ""
    layers = []
    i = 0
    while f"{pfx}encoder.layers.{i}.layer_norm1.weight" in sd:
        lp = f"{pfx}encoder.layers.{i}"
        layers.append({
            "ln1": _norm(sd, f"{lp}.layer_norm1"),
            "attn": {
                "q": _linear(sd, f"{lp}.self_attn.q_proj"),
                "k": _linear(sd, f"{lp}.self_attn.k_proj"),
                "v": _linear(sd, f"{lp}.self_attn.v_proj"),
                "o": _linear(sd, f"{lp}.self_attn.out_proj"),
            },
            "ln2": _norm(sd, f"{lp}.layer_norm2"),
            "mlp": {
                "fc1": _linear(sd, f"{lp}.mlp.fc1"),
                "fc2": _linear(sd, f"{lp}.mlp.fc2"),
            },
        })
        i += 1
    return {
        "token_embedding": {"table": _f32(
            sd[f"{pfx}embeddings.token_embedding.weight"])},
        "position_embedding": {"table": _f32(
            sd[f"{pfx}embeddings.position_embedding.weight"])},
        "layers": _stack(layers),
        "final_ln": _norm(sd, f"{pfx}final_layer_norm"),
    }


# ---------------------------------------------------------------------------
# config inference from the dir's config.json files


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def unet_config_from_diffusers(cfg: dict):
    """diffusers UNet2DConditionModel config.json → ``models.unet.UNetConfig``
    (SD-1.x layouts; the reference's ``load_model`` rebuilds a pipeline from
    any save_pretrained dir, utils.py:181-230)."""
    from sdbc_tpu_torch.models.unet import UNetConfig

    down = cfg.get("down_block_types",
                   ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"])
    up = cfg.get("up_block_types",
                 ["UpBlock2D"] + ["CrossAttnUpBlock2D"] * 3)
    for t in down:
        if t not in ("CrossAttnDownBlock2D", "DownBlock2D"):
            raise ValueError(f"unsupported UNet down block type {t!r}")
    cross = tuple(t == "CrossAttnDownBlock2D" for t in down)
    expect_up = ["CrossAttnUpBlock2D" if c else "UpBlock2D"
                 for c in reversed(cross)]
    if list(up) != expect_up:
        raise ValueError(
            f"up_block_types {up} are not the mirror of down_block_types "
            f"{down}; this UNet layout is unsupported")
    if cfg.get("time_cond_proj_dim"):
        raise ValueError(
            "UNet has time_cond_proj_dim (fully-distilled LCM/guidance-"
            "embedded checkpoint); unsupported — use LCM-LoRA weights "
            "merged onto a standard UNet instead")
    # diffusers-0.7.2 passes attention_head_dim as the head COUNT
    heads = cfg.get("attention_head_dim", 8)
    if isinstance(heads, (list, tuple)):
        if len(set(heads)) > 1:
            raise NotImplementedError(
                f"per-block head counts {tuple(heads)} (SD-2.x/SDXL) are "
                "not ported yet (ROADMAP Queue 1 item 9)")
        heads = heads[0]
    depth = cfg.get("transformer_layers_per_block", 1)
    if isinstance(depth, (list, tuple)):
        depth = max(depth)
    if depth != 1:
        raise NotImplementedError(f"transformer_layers_per_block {depth} "
                                  "(SDXL) is not ported yet (ROADMAP Queue "
                                  "1 item 9)")
    if cfg.get("addition_embed_type"):
        raise NotImplementedError(
            f"addition_embed_type {cfg['addition_embed_type']!r} (SDXL) is "
            "not ported yet (ROADMAP Queue 1 item 9)")
    return UNetConfig(
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels",
                                         (320, 640, 1280, 1280))),
        layers_per_block=cfg.get("layers_per_block", 2),
        cross_attention_dim=cfg.get("cross_attention_dim", 768),
        attention_heads=heads,
        norm_groups=cfg.get("norm_num_groups", 32),
        cross_attn_blocks=cross,
    )


def vae_config_from_diffusers(cfg: dict):
    from sdbc_tpu_torch.models.vae import VAEConfig

    for t in cfg.get("down_block_types", ["DownEncoderBlock2D"]):
        if t != "DownEncoderBlock2D":
            raise ValueError(f"unsupported VAE down block type {t!r}")
    for t in cfg.get("up_block_types", ["UpDecoderBlock2D"]):
        if t != "UpDecoderBlock2D":
            raise ValueError(f"unsupported VAE up block type {t!r}")
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels",
                                         (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
    )


def clip_config_from_diffusers(cfg: dict):
    """transformers CLIPTextConfig json → ``models.clip.CLIPTextConfig``."""
    from sdbc_tpu_torch.models.clip import CLIPTextConfig

    if "CLIPTextModelWithProjection" in (cfg.get("architectures") or []):
        raise NotImplementedError("CLIPTextModelWithProjection (SDXL's "
                                  "text_encoder_2) is not ported yet "
                                  "(ROADMAP Queue 1 item 9)")
    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden=cfg.get("hidden_size", 768),
        layers=cfg.get("num_hidden_layers", 12),
        heads=cfg.get("num_attention_heads", 12),
        mlp=cfg.get("intermediate_size", 3072),
        ctx=cfg.get("max_position_embeddings", 77),
        eps=cfg.get("layer_norm_eps", 1e-5),
        act=cfg.get("hidden_act", "quick_gelu"),
    )


def pipeline_config_from_diffusers(root: str, scheduler: str = "ddim"):
    """A ``PipelineConfig`` from a diffusers SD-1.x dir's component
    config.json files, SD-1.5 defaults for components without one.

    The schedule is the reference's HARDCODED scaled-linear 0.00085→0.012
    construction (utils.py:222-224, inference.py:386-387); only
    ``prediction_type`` is read from the saved scheduler config, since it
    changes the model's output semantics."""
    import dataclasses

    from sdbc_tpu_torch.diffusion.graph import PipelineConfig
    from sdbc_tpu_torch.diffusion.schedulers import ScheduleConfig

    if os.path.exists(os.path.join(root, "text_encoder_2")):
        raise NotImplementedError(f"{root} has a text_encoder_2 (SDXL): "
                                  "not ported yet (ROADMAP Queue 1 item 9)")
    base = PipelineConfig.sd15(scheduler)
    parts = {"unet": base.unet, "vae": base.vae, "text_encoder": base.clip}
    readers = {"unet": unet_config_from_diffusers,
               "vae": vae_config_from_diffusers,
               "text_encoder": clip_config_from_diffusers}
    for comp, read in readers.items():
        p = os.path.join(root, comp, "config.json")
        if os.path.exists(p):
            parts[comp] = read(_read_json(p))
    schedule = ScheduleConfig.sd15()
    p = os.path.join(root, "scheduler", "scheduler_config.json")
    if os.path.exists(p):
        sc = _read_json(p)
        if "prediction_type" in sc:
            schedule = dataclasses.replace(
                schedule, prediction_type=sc["prediction_type"])
    return PipelineConfig(clip=parts["text_encoder"], unet=parts["unet"],
                          vae=parts["vae"], schedule=schedule,
                          scheduler=scheduler)


def port_diffusers_checkpoint(root: str) -> dict:
    """A diffusers SD-1.x save_pretrained dir → {text_encoder, unet, vae}
    trees (for ``SDPipeline``)."""
    if os.path.isdir(os.path.join(root, "text_encoder_2")):
        raise NotImplementedError(f"{root} has a text_encoder_2 (SDXL): "
                                  "not ported yet (ROADMAP Queue 1 item 9)")
    params = {}
    for comp, fn in (("unet", port_unet), ("vae", port_vae),
                     ("text_encoder", port_clip_text)):
        cdir = os.path.join(root, comp)
        if os.path.isdir(cdir):
            params[comp] = fn(load_state_dict(cdir))
    if not params:
        raise FileNotFoundError(f"no portable components under {root}")
    return params


# ---------------------------------------------------------------------------
# FID InceptionV3 (pt-inception-2015-12-05 / torchvision naming)


def _inc_cbr(sd, name):
    """BasicConv2d: conv + BN(gamma, beta, running stats)."""
    return {
        "w": _f32(np.transpose(sd[f"{name}.conv.weight"], (2, 3, 1, 0))),
        "gamma": _f32(sd[f"{name}.bn.weight"]),
        "beta": _f32(sd[f"{name}.bn.bias"]),
        "mean": _f32(sd[f"{name}.bn.running_mean"]),
        "var": _f32(sd[f"{name}.bn.running_var"]),
    }


def port_fid_inception(sd: Dict[str, np.ndarray]) -> dict:
    """pt_inception-2015-12-05 (pytorch-fid) state dict → the Inception
    tree (``models.inception.from_tree``): THE standard FID weights, a port
    of the reference's frozen TF graph (fid.py:273)."""
    c = _inc_cbr
    p = {"stem": {
        "c1": c(sd, "Conv2d_1a_3x3"),
        "c2": c(sd, "Conv2d_2a_3x3"),
        "c3": c(sd, "Conv2d_2b_3x3"),
        "c4": c(sd, "Conv2d_3b_1x1"),
        "c5": c(sd, "Conv2d_4a_3x3"),
    }}
    p["mixed35"] = [{
        "b1x1": c(sd, f"{blk}.branch1x1"),
        "b5x5_1": c(sd, f"{blk}.branch5x5_1"),
        "b5x5_2": c(sd, f"{blk}.branch5x5_2"),
        "b3x3_1": c(sd, f"{blk}.branch3x3dbl_1"),
        "b3x3_2": c(sd, f"{blk}.branch3x3dbl_2"),
        "b3x3_3": c(sd, f"{blk}.branch3x3dbl_3"),
        "pool": c(sd, f"{blk}.branch_pool"),
    } for blk in ("Mixed_5b", "Mixed_5c", "Mixed_5d")]
    p["red17"] = {
        "b3x3": c(sd, "Mixed_6a.branch3x3"),
        "b3x3d_1": c(sd, "Mixed_6a.branch3x3dbl_1"),
        "b3x3d_2": c(sd, "Mixed_6a.branch3x3dbl_2"),
        "b3x3d_3": c(sd, "Mixed_6a.branch3x3dbl_3"),
    }
    p["mixed17"] = [{
        "b1x1": c(sd, f"{blk}.branch1x1"),
        "b7x7_1": c(sd, f"{blk}.branch7x7_1"),
        "b7x7_2": c(sd, f"{blk}.branch7x7_2"),
        "b7x7_3": c(sd, f"{blk}.branch7x7_3"),
        "b7x7d_1": c(sd, f"{blk}.branch7x7dbl_1"),
        "b7x7d_2": c(sd, f"{blk}.branch7x7dbl_2"),
        "b7x7d_3": c(sd, f"{blk}.branch7x7dbl_3"),
        "b7x7d_4": c(sd, f"{blk}.branch7x7dbl_4"),
        "b7x7d_5": c(sd, f"{blk}.branch7x7dbl_5"),
        "pool": c(sd, f"{blk}.branch_pool"),
    } for blk in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e")]
    p["red8"] = {
        "b3x3_1": c(sd, "Mixed_7a.branch3x3_1"),
        "b3x3_2": c(sd, "Mixed_7a.branch3x3_2"),
        "b7x7_1": c(sd, "Mixed_7a.branch7x7x3_1"),
        "b7x7_2": c(sd, "Mixed_7a.branch7x7x3_2"),
        "b7x7_3": c(sd, "Mixed_7a.branch7x7x3_3"),
        "b7x7_4": c(sd, "Mixed_7a.branch7x7x3_4"),
    }
    p["mixed8"] = [{
        "b1x1": c(sd, f"{blk}.branch1x1"),
        "b3x3_1": c(sd, f"{blk}.branch3x3_1"),
        "b3x3_2a": c(sd, f"{blk}.branch3x3_2a"),
        "b3x3_2b": c(sd, f"{blk}.branch3x3_2b"),
        "b3x3d_1": c(sd, f"{blk}.branch3x3dbl_1"),
        "b3x3d_2": c(sd, f"{blk}.branch3x3dbl_2"),
        "b3x3d_3a": c(sd, f"{blk}.branch3x3dbl_3a"),
        "b3x3d_3b": c(sd, f"{blk}.branch3x3dbl_3b"),
        "pool": c(sd, f"{blk}.branch_pool"),
    } for blk in ("Mixed_7b", "Mixed_7c")]
    return p


def load_fid_inception(weights_path: str) -> dict:
    """pt_inception-2015-12-05-*.pth (torch) or a pytorch-fid-keyed .npz
    of it → the Inception tree."""
    if weights_path.endswith(".npz"):
        with np.load(weights_path) as flat:
            return port_fid_inception(dict(flat))
    return port_fid_inception(_torch_load(weights_path))

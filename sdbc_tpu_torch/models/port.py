"""Diffusers checkpoints of the SD-1.x, SD-2.x and SDXL families (base and
refiner) and the pytorch-fid Inception weights into the port (counterpart
of the importers of ``sdbc_tpu/models/port.py``).

Each ``port_*`` returns the JAX package's nested numpy parameter tree, the
carrier of weights across the two packages: ``models.convert.
load_jax_params`` (``SDPipeline`` does it for a ``{"text_encoder", "unet",
"vae"}`` dict) and ``models.inception.from_tree`` build the modules.

Conventions (the JAX module's):
  - torch conv (O, I, H, W) → HWIO (H, W, I, O); torch linear (O, I) →
    (I, O); every leaf float32;
  - CLIP's per-layer parameters stacked along a leading layer axis, and
    a depth > 1 transformer's blocks along a leading depth axis
    (``"blocks"``; depth 1 keeps the flat layout).

Also a diffusers ControlNetModel (``load_controlnet``, for
``models.controlnet``; SD-1.x and SDXL layouts), the CLIP vision tower,
diffusers' safety checker (``safety_checker_from_dir``, for
``models.safety``) and a transformers CLIPModel (``clip_model_from_dir``,
for ``eval.clip_score``).  The dedicated inpainting UNet is a UNet whose
config says ``in_channels`` 9.

Sources: ``.safetensors`` through ``read_safetensors`` (a reader of the
format written here: the ``safetensors`` package is not needed), ``.bin``
and ``.pth`` through ``torch.load(weights_only=True)``.

The other direction (``sdbc_tpu/models/port.py:622-968``): ``export_*``
turn trees in the JAX layout back into diffusers-named state dicts, and
``export_diffusers_checkpoint`` writes a ``save_pretrained`` directory
with ``write_safetensors`` (the format's writer, in the logical order of
every array, views included); ``pipeline_trees`` gives an
``SDPipeline``'s trees, so a model the port trained can be exported.
``port_bart`` takes a transformers ``BartForConditionalGeneration``
state dict to ``models.bart``'s tree.
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


_ST_NAMES = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def write_safetensors(tensors: Dict[str, np.ndarray], path: str) -> int:
    """Write {name: numpy array} (the dtypes of ``_ST_DTYPES``) as a
    ``.safetensors`` file, the layout ``read_safetensors`` reads: the
    header JSON padded with spaces to a multiple of 8 bytes, then each
    array's C-ordered little-endian bytes in the order of dtype width
    (widest first) and name, as the ``safetensors`` package orders them.
    A view (a transpose) is written in its logical order, not as its
    buffer lies.  Returns the bytes written."""
    arrays = {}
    for name, value in tensors.items():
        arr = np.asarray(value)
        if arr.dtype.newbyteorder("=") not in _ST_NAMES:
            raise ValueError(f"{name}: dtype {arr.dtype} has no safetensors "
                             "name this writer takes")
        arrays[name] = np.asarray(arr, arr.dtype.newbyteorder("<"),
                                  order="C")
    order = sorted(arrays, key=lambda n: (-arrays[n].dtype.itemsize, n))
    header, offset = {}, 0
    for name in order:
        arr = arrays[name]
        header[name] = {"dtype": _ST_NAMES[arr.dtype.newbyteorder("=")],
                        "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            if arrays[name].nbytes:
                f.write(memoryview(arrays[name].reshape(-1)).cast("B"))
    return 8 + len(raw) + offset


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


def _port_basic_block(sd, tb):
    attn = lambda a: {"q": _linear(sd, f"{tb}.{a}.to_q"),
                      "k": _linear(sd, f"{tb}.{a}.to_k"),
                      "v": _linear(sd, f"{tb}.{a}.to_v"),
                      "o": _linear(sd, f"{tb}.{a}.to_out.0")}
    return {
        "ln1": _norm(sd, f"{tb}.norm1"),
        "attn1": attn("attn1"),
        "ln2": _norm(sd, f"{tb}.norm2"),
        "attn2": attn("attn2"),
        "ln3": _norm(sd, f"{tb}.norm3"),
        "geglu": _linear(sd, f"{tb}.ff.net.0.proj"),
        "ff_out": _linear(sd, f"{tb}.ff.net.2"),
    }


def _port_transformer(sd, pfx):
    p = {
        "norm": _norm(sd, f"{pfx}.norm"),
        "proj_in": _proj_conv(sd, f"{pfx}.proj_in"),
        "proj_out": _proj_conv(sd, f"{pfx}.proj_out"),
    }
    depth = 0
    while f"{pfx}.transformer_blocks.{depth}.norm1.weight" in sd:
        depth += 1
    blocks = [_port_basic_block(sd, f"{pfx}.transformer_blocks.{i}")
              for i in range(depth)]
    if depth == 1:  # SD-1.x/2.x: the flat layout
        p.update(blocks[0])
    else:  # SDXL: the blocks stacked
        p["blocks"] = _stack(blocks)
    return p


def port_unet(sd: Dict[str, np.ndarray]) -> dict:
    """diffusers UNet2DConditionModel state dict → the UNet tree."""
    if "time_embedding.cond_proj.weight" in sd:
        raise ValueError(
            "UNet weights carry time_embedding.cond_proj (fully-distilled "
            "LCM/guidance-embedded checkpoint); unsupported — use LCM-LoRA "
            "weights merged onto a standard UNet instead")
    p = {
        "conv_in": _conv(sd, "conv_in"),
        "time_mlp": {
            "fc1": _linear(sd, "time_embedding.linear_1"),
            "fc2": _linear(sd, "time_embedding.linear_2"),
        },
        "norm_out": _norm(sd, "conv_norm_out"),
        "conv_out": _conv(sd, "conv_out"),
    }
    if "add_embedding.linear_1.weight" in sd:  # SDXL's text-time embedding
        p["add_mlp"] = {"fc1": _linear(sd, "add_embedding.linear_1"),
                        "fc2": _linear(sd, "add_embedding.linear_2")}

    for side, key in (("down", "down_blocks"), ("up", "up_blocks")):
        p[side] = _port_blocks(sd, key)
    p["mid"] = _port_mid(sd)
    return p


def _port_block(sd, prefix):
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


def _port_blocks(sd, key):
    out, i = [], 0
    while f"{key}.{i}.resnets.0.norm1.weight" in sd:
        out.append(_port_block(sd, f"{key}.{i}"))
        i += 1
    return out


def _port_mid(sd):
    return {"resnet1": _port_resnet(sd, "mid_block.resnets.0"),
            "attn": _port_transformer(sd, "mid_block.attentions.0"),
            "resnet2": _port_resnet(sd, "mid_block.resnets.1")}


def _indexed(sd, name: str) -> list:
    """``_conv`` of ``name.0``, ``name.1``, … while they exist."""
    out, j = [], 0
    while f"{name}.{j}.weight" in sd:
        out.append(_conv(sd, f"{name}.{j}"))
        j += 1
    return out


def port_controlnet(sd: Dict[str, np.ndarray]) -> dict:
    """diffusers ControlNetModel state dict → the ``models.controlnet``
    tree (JAX ``port.py:210-260``): the encoder half under the UNet's
    names, ``controlnet_cond_embedding.{conv_in,blocks.N,conv_out}`` and
    the zero convs ``controlnet_down_blocks.N`` / ``controlnet_mid_block``
    (SDXL's ``add_embedding`` too)."""
    p = {"conv_in": _conv(sd, "conv_in"),
         "time_mlp": {"fc1": _linear(sd, "time_embedding.linear_1"),
                      "fc2": _linear(sd, "time_embedding.linear_2")}}
    if "add_embedding.linear_1.weight" in sd:  # SDXL ControlNet
        p["add_mlp"] = {"fc1": _linear(sd, "add_embedding.linear_1"),
                        "fc2": _linear(sd, "add_embedding.linear_2")}
    p["down"] = _port_blocks(sd, "down_blocks")
    p["mid"] = _port_mid(sd)
    p["cond_embedding"] = {
        "conv_in": _conv(sd, "controlnet_cond_embedding.conv_in"),
        "blocks": _indexed(sd, "controlnet_cond_embedding.blocks"),
        "conv_out": _conv(sd, "controlnet_cond_embedding.conv_out")}
    p["zero_down"] = _indexed(sd, "controlnet_down_blocks")
    p["zero_mid"] = _conv(sd, "controlnet_mid_block")
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


def _clip_layers(sd, pfx):
    """The stacked tree of a CLIP encoder's ``{pfx}encoder.layers.<i>``."""
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
    return layers


def port_clip_text(sd: Dict[str, np.ndarray]) -> dict:
    """transformers CLIPTextModel state dict → the text-encoder tree, with
    ``text_projection`` when the dict has one (CLIPTextModelWithProjection,
    or a CLIPModel's text half)."""
    pfx = "text_model." if "text_model.final_layer_norm.weight" in sd else ""
    out = {
        "token_embedding": {"table": _f32(
            sd[f"{pfx}embeddings.token_embedding.weight"])},
        "position_embedding": {"table": _f32(
            sd[f"{pfx}embeddings.position_embedding.weight"])},
        "layers": _stack(_clip_layers(sd, pfx)),
        "final_ln": _norm(sd, f"{pfx}final_layer_norm"),
    }
    if "text_projection.weight" in sd:
        out["text_projection"] = _linear(sd, "text_projection")
    return out


# ---------------------------------------------------------------------------
# CLIP vision tower, safety checker, CLIPModel


def port_clip_vision(sd: Dict[str, np.ndarray]) -> dict:
    """transformers CLIPVisionModel state dict ("vision_model.…", or the
    bare CLIPVisionTransformer's "embeddings.…") → the vision-tower tree."""
    pfx = "vision_model." if "vision_model.post_layernorm.weight" in sd \
        else ""
    layers = _clip_layers(sd, pfx)
    if not layers:
        raise ValueError("no CLIP vision encoder layers found in state dict")
    return {
        "class_embedding": _f32(sd[f"{pfx}embeddings.class_embedding"]),
        "patch_embedding": _conv(sd, f"{pfx}embeddings.patch_embedding"),
        "position_embedding": {"table": _f32(
            sd[f"{pfx}embeddings.position_embedding.weight"])},
        "pre_ln": _norm(sd, f"{pfx}pre_layrnorm"),  # transformers' spelling
        "layers": _stack(layers),
        "post_ln": _norm(sd, f"{pfx}post_layernorm"),
    }


def _strip(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def port_safety_checker(sd: Dict[str, np.ndarray]) -> dict:
    """StableDiffusionSafetyChecker state dict → the ``SafetyModel`` tree:
    the nested CLIPVisionModel ("vision_model.vision_model.…"), the visual
    projection, the concept tables and their thresholds."""
    return {
        "vision": port_clip_vision(_strip(sd, "vision_model.")),
        "visual_projection": _linear(sd, "visual_projection"),
        "concept_embeds": _f32(sd["concept_embeds"]),
        "concept_weights": _f32(sd["concept_embeds_weights"]),
        "special_care_embeds": _f32(sd["special_care_embeds"]),
        "special_care_weights": _f32(sd["special_care_embeds_weights"]),
    }


def _vision_config(raw: dict, base):
    from sdbc_tpu_torch.models.clip import CLIPVisionConfig

    return CLIPVisionConfig(
        hidden=raw.get("hidden_size", base.hidden),
        layers=raw.get("num_hidden_layers", base.layers),
        heads=raw.get("num_attention_heads", base.heads),
        mlp=raw.get("intermediate_size", base.mlp),
        patch=raw.get("patch_size", base.patch),
        image_size=raw.get("image_size", base.image_size),
        eps=raw.get("layer_norm_eps", base.eps),
        act=raw.get("hidden_act", base.act))


def safety_checker_from_dir(path: str):
    """A diffusers ``safety_checker`` dir → (tree, CLIPVisionConfig): the
    tower's geometry from config.json's vision_config (ViT-L/14 defaults),
    the weights ported; for ``models.safety.ClipSafetyChecker``."""
    from sdbc_tpu_torch.models.clip import CLIPVisionConfig

    vcfg = CLIPVisionConfig.sd_safety()
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(cfg_path):
        vcfg = _vision_config(_read_json(cfg_path).get("vision_config", {}),
                              vcfg)
    return port_safety_checker(load_state_dict(path)), vcfg


def clip_model_from_dir(path: str):
    """A transformers CLIPModel save dir → (tree, CLIPTextConfig,
    CLIPVisionConfig) for ``eval.clip_score.ClipScorer``: {"text" (with
    text_projection), "vision", "visual_projection"}."""
    from sdbc_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig

    raw = _read_json(os.path.join(path, "config.json"))
    tc, vc = raw.get("text_config", {}), raw.get("vision_config", {})
    text_cfg = CLIPTextConfig(
        vocab_size=tc.get("vocab_size", 49408),
        hidden=tc.get("hidden_size", 512),
        layers=tc.get("num_hidden_layers", 12),
        heads=tc.get("num_attention_heads", 8),
        mlp=tc.get("intermediate_size", 2048),
        ctx=tc.get("max_position_embeddings", 77),
        eps=tc.get("layer_norm_eps", 1e-5),
        act=tc.get("hidden_act", "quick_gelu"),
        projection_dim=raw.get("projection_dim", 512))
    vision_cfg = _vision_config(vc, CLIPVisionConfig(
        hidden=768, layers=12, heads=12, mlp=3072, patch=32))
    sd = load_state_dict(path)
    tree = {"text": port_clip_text(sd),
            "vision": port_clip_vision(_strip(sd, "vision_model.")),
            "visual_projection": _linear(sd, "visual_projection")}
    if "text_projection" not in tree["text"]:
        raise ValueError(f"{path}: no text_projection in state dict — not "
                         "a CLIPModel checkpoint")
    return tree, text_cfg, vision_cfg


# ---------------------------------------------------------------------------
# config inference from the dir's config.json files


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def unet_config_from_diffusers(cfg: dict):
    """diffusers UNet2DConditionModel config.json → ``models.unet.UNetConfig``
    (the reference's ``load_model`` rebuilds a pipeline from any
    save_pretrained dir, utils.py:181-230)."""
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
    # diffusers-0.7.2 passes attention_head_dim as the head COUNT (SD-1.x's
    # 8; SD-2.x's and SDXL's per-block (5, 10, 20[, 20]))
    heads = cfg.get("attention_head_dim", 8)
    if isinstance(heads, (list, tuple)):
        heads = tuple(heads) if len(set(heads)) > 1 else heads[0]
    depth = cfg.get("transformer_layers_per_block", 1)
    if isinstance(depth, (list, tuple)):
        depth = tuple(depth) if len(set(depth)) > 1 else depth[0]
    add_type = cfg.get("addition_embed_type")
    add_dim = None
    if add_type == "text_time":  # SDXL's micro-conditioning
        add_dim = cfg.get("projection_class_embeddings_input_dim")
        if not add_dim:
            raise ValueError("addition_embed_type=text_time needs "
                             "projection_class_embeddings_input_dim")
    elif add_type:
        raise ValueError(f"unsupported addition_embed_type {add_type!r} "
                         "(only SDXL's 'text_time' is implemented)")
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
        transformer_depth=depth,
        addition_embed_dim=add_dim,
        addition_time_embed_dim=cfg.get("addition_time_embed_dim", 256),
    )


def controlnet_config_from_diffusers(cfg: dict, unet_cfg=None):
    """diffusers ControlNetModel config.json → ``ControlNetConfig`` (JAX
    ``port.py:263-299``).  The ControlNet config carries the encoder's
    fields itself (no up blocks, no out_channels: both synthesised for
    ``unet_config_from_diffusers``, which takes the SDXL fields too);
    ``unet_cfg`` overrides it with the base's.  A conditioning channel
    order other than "rgb" is refused."""
    from sdbc_tpu_torch.models.controlnet import ControlNetConfig

    if unet_cfg is None:
        down = cfg.get("down_block_types",
                       ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"])
        for t in down:
            if t not in ("CrossAttnDownBlock2D", "DownBlock2D"):
                raise ValueError(f"unsupported ControlNet block type {t!r}")
        mirror = ["CrossAttnUpBlock2D" if t == "CrossAttnDownBlock2D"
                  else "UpBlock2D" for t in reversed(down)]
        unet_cfg = unet_config_from_diffusers(
            {**cfg, "down_block_types": list(down), "up_block_types": mirror,
             "out_channels": cfg.get("out_channels", 4)})
    order = cfg.get("controlnet_conditioning_channel_order", "rgb")
    if order != "rgb":
        raise ValueError(f"conditioning channel order {order!r} unsupported "
                         "(pre-swap the control image instead)")
    return ControlNetConfig(
        unet=unet_cfg,
        conditioning_channels=tuple(
            cfg.get("conditioning_embedding_out_channels",
                    (16, 32, 96, 256))))


def load_controlnet(path: str):
    """A diffusers ControlNetModel dir → (tree, ``ControlNetConfig``).
    ``path``: the model dir or a pipeline dir with a ``controlnet/``
    subfolder (the layout diffusers' StableDiffusionControlNetPipeline
    saves)."""
    sub = os.path.join(path, "controlnet")
    if os.path.isdir(sub):
        path = sub
    cfg_path = os.path.join(path, "config.json")
    cfg_json = _read_json(cfg_path) if os.path.exists(cfg_path) else {}
    return (port_controlnet(load_state_dict(path)),
            controlnet_config_from_diffusers(cfg_json))


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

    # projection_dim is in every transformers CLIP config; only
    # CLIPTextModelWithProjection owns projection weights
    with_proj = "CLIPTextModelWithProjection" in (cfg.get("architectures")
                                                  or [])
    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden=cfg.get("hidden_size", 768),
        layers=cfg.get("num_hidden_layers", 12),
        heads=cfg.get("num_attention_heads", 12),
        mlp=cfg.get("intermediate_size", 3072),
        ctx=cfg.get("max_position_embeddings", 77),
        eps=cfg.get("layer_norm_eps", 1e-5),
        act=cfg.get("hidden_act", "quick_gelu"),
        projection_dim=cfg.get("projection_dim") if with_proj else None,
    )


def pipeline_config_from_diffusers(root: str, scheduler: str = "ddim"):
    """A ``PipelineConfig`` from a diffusers dir's component config.json
    files, SD-1.5 defaults for components without one.  A
    ``text_encoder_2`` makes it SDXL; with no ``text_encoder`` config
    beside it, the refiner (bigG alone, aesthetic-score ids).

    The schedule is the reference's HARDCODED scaled-linear 0.00085→0.012
    construction (utils.py:222-224, inference.py:386-387); only
    ``prediction_type`` is read from the saved scheduler config, since it
    changes the model's output semantics."""
    import dataclasses

    from sdbc_tpu_torch.diffusion.graph import PipelineConfig
    from sdbc_tpu_torch.diffusion.schedulers import ScheduleConfig

    base = PipelineConfig.sd15(scheduler)
    parts = {"unet": base.unet, "vae": base.vae, "text_encoder": base.clip}
    readers = {"unet": unet_config_from_diffusers,
               "vae": vae_config_from_diffusers,
               "text_encoder": clip_config_from_diffusers}
    for comp, read in readers.items():
        p = os.path.join(root, comp, "config.json")
        if os.path.exists(p):
            parts[comp] = read(_read_json(p))
    clip2, refiner = None, False
    p = os.path.join(root, "text_encoder_2", "config.json")
    if os.path.exists(p):  # SDXL's second encoder
        clip2 = clip_config_from_diffusers(_read_json(p))
        if not parts["unet"].addition_embed_dim:
            raise ValueError(
                f"{root} has a text_encoder_2 but its UNet config has no "
                "text_time addition embedding: not an SDXL layout")
        if not os.path.exists(os.path.join(root, "text_encoder",
                                           "config.json")):
            # the refiner: diffusers saves text_encoder as null
            refiner = True
            parts["text_encoder"] = clip2
    schedule = ScheduleConfig.sd15()
    p = os.path.join(root, "scheduler", "scheduler_config.json")
    if os.path.exists(p):
        sc = _read_json(p)
        if "prediction_type" in sc:
            schedule = dataclasses.replace(
                schedule, prediction_type=sc["prediction_type"])
    return PipelineConfig(clip=parts["text_encoder"], unet=parts["unet"],
                          vae=parts["vae"], schedule=schedule,
                          scheduler=scheduler, clip2=clip2, refiner=refiner)


def port_diffusers_checkpoint(root: str) -> dict:
    """A diffusers save_pretrained dir → the trees of its components
    (unet, vae, text_encoder and SDXL's text_encoder_2; for
    ``SDPipeline``)."""
    params = {}
    for comp, fn in (("unet", port_unet), ("vae", port_vae),
                     ("text_encoder", port_clip_text),
                     ("text_encoder_2", port_clip_text)):
        cdir = os.path.join(root, comp)
        if os.path.isdir(cdir):
            params[comp] = fn(load_state_dict(cdir))
    if not params:
        raise FileNotFoundError(f"no portable components under {root}")
    return params


# ---------------------------------------------------------------------------
# export (trees in the JAX layout → diffusers-named state dicts)


def _exp_conv(out, name, p):
    # ascontiguousarray: a transposed view's buffer is not its logical
    # order (write_safetensors copies anyway; the dict stays plain)
    out[f"{name}.weight"] = np.ascontiguousarray(
        np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))
    if "b" in p:
        out[f"{name}.bias"] = np.asarray(p["b"])


def _exp_linear(out, name, p):
    out[f"{name}.weight"] = np.ascontiguousarray(
        np.transpose(np.asarray(p["w"]), (1, 0)))
    if "b" in p:
        out[f"{name}.bias"] = np.asarray(p["b"])


def _exp_norm(out, name, p):
    out[f"{name}.weight"] = np.asarray(p["scale"])
    out[f"{name}.bias"] = np.asarray(p["bias"])


def _exp_resnet(out, pfx, p):
    _exp_norm(out, f"{pfx}.norm1", p["norm1"])
    _exp_conv(out, f"{pfx}.conv1", p["conv1"])
    _exp_norm(out, f"{pfx}.norm2", p["norm2"])
    _exp_conv(out, f"{pfx}.conv2", p["conv2"])
    if "temb" in p:
        _exp_linear(out, f"{pfx}.time_emb_proj", p["temb"])
    if "shortcut" in p:
        _exp_conv(out, f"{pfx}.conv_shortcut", p["shortcut"])


def _exp_basic_block(out, tb, p):
    _exp_norm(out, f"{tb}.norm1", p["ln1"])
    _exp_norm(out, f"{tb}.norm2", p["ln2"])
    _exp_norm(out, f"{tb}.norm3", p["ln3"])
    for attn in ("attn1", "attn2"):
        _exp_linear(out, f"{tb}.{attn}.to_q", p[attn]["q"])
        _exp_linear(out, f"{tb}.{attn}.to_k", p[attn]["k"])
        _exp_linear(out, f"{tb}.{attn}.to_v", p[attn]["v"])
        _exp_linear(out, f"{tb}.{attn}.to_out.0", p[attn]["o"])
    _exp_linear(out, f"{tb}.ff.net.0.proj", p["geglu"])
    _exp_linear(out, f"{tb}.ff.net.2", p["ff_out"])


def _exp_proj_linear(out, name, p):
    """A (1,1,in,out) conv kernel as the 2-D (out,in) linear of SDXL's
    ``use_linear_projection`` layout."""
    out[f"{name}.weight"] = np.ascontiguousarray(
        np.transpose(np.asarray(p["w"])[0, 0], (1, 0)))
    if "b" in p:
        out[f"{name}.bias"] = np.asarray(p["b"])


def _index(tree, i: int):
    """Entry ``i`` along the leading axis of every leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _exp_transformer(out, pfx, p):
    _exp_norm(out, f"{pfx}.norm", p["norm"])
    if "blocks" in p:
        # depth > 1, the SDXL convention: linear proj_in/out, the blocks
        # unstacked
        _exp_proj_linear(out, f"{pfx}.proj_in", p["proj_in"])
        _exp_proj_linear(out, f"{pfx}.proj_out", p["proj_out"])
        depth = np.asarray(p["blocks"]["ln1"]["scale"]).shape[0]
        for i in range(depth):
            _exp_basic_block(out, f"{pfx}.transformer_blocks.{i}",
                             _index(p["blocks"], i))
        return
    _exp_conv(out, f"{pfx}.proj_in", p["proj_in"])
    _exp_basic_block(out, f"{pfx}.transformer_blocks.0", p)
    _exp_conv(out, f"{pfx}.proj_out", p["proj_out"])


def _exp_embeddings(out, params):
    """conv_in, the time MLP and SDXL's text-time ``add_mlp``."""
    _exp_conv(out, "conv_in", params["conv_in"])
    _exp_linear(out, "time_embedding.linear_1", params["time_mlp"]["fc1"])
    _exp_linear(out, "time_embedding.linear_2", params["time_mlp"]["fc2"])
    if "add_mlp" in params:
        _exp_linear(out, "add_embedding.linear_1", params["add_mlp"]["fc1"])
        _exp_linear(out, "add_embedding.linear_2", params["add_mlp"]["fc2"])


def _exp_block(out, prefix, blk):
    for j, r in enumerate(blk["resnets"]):
        _exp_resnet(out, f"{prefix}.resnets.{j}", r)
    for j, a in enumerate(blk.get("attns", ())):
        _exp_transformer(out, f"{prefix}.attentions.{j}", a)
    if "downsample" in blk:
        _exp_conv(out, f"{prefix}.downsamplers.0.conv", blk["downsample"])
    if "upsample" in blk:
        _exp_conv(out, f"{prefix}.upsamplers.0.conv", blk["upsample"])


def _exp_mid(out, mid):
    _exp_resnet(out, "mid_block.resnets.0", mid["resnet1"])
    _exp_transformer(out, "mid_block.attentions.0", mid["attn"])
    _exp_resnet(out, "mid_block.resnets.1", mid["resnet2"])


def export_unet(params: dict) -> Dict[str, np.ndarray]:
    """The UNet tree → a diffusers UNet2DConditionModel state dict (the
    inverse of ``port_unet``)."""
    out: Dict[str, np.ndarray] = {}
    _exp_embeddings(out, params)
    _exp_norm(out, "conv_norm_out", params["norm_out"])
    _exp_conv(out, "conv_out", params["conv_out"])
    for side, key in (("down", "down_blocks"), ("up", "up_blocks")):
        for i, blk in enumerate(params[side]):
            _exp_block(out, f"{key}.{i}", blk)
    _exp_mid(out, params["mid"])
    return out


def export_controlnet(params: dict) -> Dict[str, np.ndarray]:
    """The ``models.controlnet`` tree → a diffusers ControlNetModel state
    dict (the inverse of ``port_controlnet``)."""
    out: Dict[str, np.ndarray] = {}
    _exp_embeddings(out, params)
    for i, blk in enumerate(params["down"]):
        _exp_block(out, f"down_blocks.{i}", blk)
    _exp_mid(out, params["mid"])
    ce = params["cond_embedding"]
    _exp_conv(out, "controlnet_cond_embedding.conv_in", ce["conv_in"])
    for j, c in enumerate(ce["blocks"]):
        _exp_conv(out, f"controlnet_cond_embedding.blocks.{j}", c)
    _exp_conv(out, "controlnet_cond_embedding.conv_out", ce["conv_out"])
    for j, z in enumerate(params["zero_down"]):
        _exp_conv(out, f"controlnet_down_blocks.{j}", z)
    _exp_conv(out, "controlnet_mid_block", params["zero_mid"])
    return out


def export_vae(params: dict) -> Dict[str, np.ndarray]:
    """The VAE tree → a diffusers AutoencoderKL state dict (new-style
    attention names)."""
    out: Dict[str, np.ndarray] = {}

    def coder(side, c, blocks_key, updown):
        _exp_conv(out, f"{side}.conv_in", c["conv_in"])
        mid, pfx = c["mid"], f"{side}.mid_block"
        _exp_resnet(out, f"{pfx}.resnets.0", mid["resnet1"])
        _exp_norm(out, f"{pfx}.attentions.0.group_norm", mid["attn"]["norm"])
        for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"),
                             ("o", "to_out.0")):
            _exp_linear(out, f"{pfx}.attentions.0.{theirs}",
                        mid["attn"][ours])
        _exp_resnet(out, f"{pfx}.resnets.1", mid["resnet2"])
        _exp_norm(out, f"{side}.conv_norm_out", c["norm_out"])
        _exp_conv(out, f"{side}.conv_out", c["conv_out"])
        for i, blk in enumerate(c[updown]):
            _exp_block(out, f"{side}.{blocks_key}.{i}", blk)

    coder("encoder", params["encoder"], "down_blocks", "down")
    coder("decoder", params["decoder"], "up_blocks", "up")
    _exp_conv(out, "quant_conv", params["quant_conv"])
    _exp_conv(out, "post_quant_conv", params["post_quant_conv"])
    return out


def export_clip_text(params: dict) -> Dict[str, np.ndarray]:
    """The text-encoder tree → a transformers CLIPTextModel state dict
    (``text_projection`` too: CLIPTextModelWithProjection)."""
    out: Dict[str, np.ndarray] = {}
    pfx = "text_model."
    out[f"{pfx}embeddings.token_embedding.weight"] = np.asarray(
        params["token_embedding"]["table"])
    out[f"{pfx}embeddings.position_embedding.weight"] = np.asarray(
        params["position_embedding"]["table"])
    _exp_norm(out, f"{pfx}final_layer_norm", params["final_ln"])
    for i in range(np.asarray(params["layers"]["ln1"]["scale"]).shape[0]):
        layer = _index(params["layers"], i)
        lp = f"{pfx}encoder.layers.{i}"
        _exp_norm(out, f"{lp}.layer_norm1", layer["ln1"])
        _exp_norm(out, f"{lp}.layer_norm2", layer["ln2"])
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"),
                             ("v", "v_proj"), ("o", "out_proj")):
            _exp_linear(out, f"{lp}.self_attn.{theirs}",
                        layer["attn"][ours])
        _exp_linear(out, f"{lp}.mlp.fc1", layer["mlp"]["fc1"])
        _exp_linear(out, f"{lp}.mlp.fc2", layer["mlp"]["fc2"])
    if "text_projection" in params:
        _exp_linear(out, "text_projection", params["text_projection"])
    return out


def _unet_config_to_diffusers(c) -> dict:
    """A ``UNetConfig`` as diffusers 0.7.2's config.json, as the JAX
    package writes it (head COUNTS as ``attention_head_dim``, the
    constructor's quirk ``unet_config_from_diffusers`` reads back)."""
    heads, depth = c.attention_heads, c.transformer_depth
    out = {
        "_class_name": "UNet2DConditionModel",
        "_diffusers_version": "0.7.2",
        "in_channels": c.in_channels,
        "out_channels": c.out_channels,
        "block_out_channels": list(c.block_out_channels),
        "layers_per_block": c.layers_per_block,
        "cross_attention_dim": c.cross_attention_dim,
        "attention_head_dim": (list(heads) if isinstance(heads, (tuple, list))
                               else heads),
        "norm_num_groups": c.norm_groups,
        "down_block_types": ["CrossAttnDownBlock2D" if x else "DownBlock2D"
                             for x in c.cross_attn_blocks],
        "up_block_types": ["CrossAttnUpBlock2D" if x else "UpBlock2D"
                           for x in reversed(c.cross_attn_blocks)],
        "act_fn": "silu",
        "sample_size": 64,
    }
    if max(depth if isinstance(depth, (tuple, list)) else (depth,)) > 1:
        out["transformer_layers_per_block"] = (
            list(depth) if isinstance(depth, (tuple, list)) else depth)
        out["use_linear_projection"] = True  # the layout _exp_proj_linear writes
    if c.addition_embed_dim:
        out["addition_embed_type"] = "text_time"
        out["projection_class_embeddings_input_dim"] = c.addition_embed_dim
        out["addition_time_embed_dim"] = c.addition_time_embed_dim
        out["sample_size"] = 128
    return out


def _vae_config_to_diffusers(c) -> dict:
    n = len(c.block_out_channels)
    return {
        "_class_name": "AutoencoderKL",
        "_diffusers_version": "0.7.2",
        "in_channels": c.in_channels,
        "out_channels": c.in_channels,
        "latent_channels": c.latent_channels,
        "block_out_channels": list(c.block_out_channels),
        "layers_per_block": c.layers_per_block,
        "norm_num_groups": c.norm_groups,
        "scaling_factor": c.scaling_factor,
        "down_block_types": ["DownEncoderBlock2D"] * n,
        "up_block_types": ["UpDecoderBlock2D"] * n,
        "act_fn": "silu",
    }


def _clip_config_to_diffusers(c) -> dict:
    out = {
        "architectures": ["CLIPTextModelWithProjection" if c.projection_dim
                          else "CLIPTextModel"],
        "model_type": "clip_text_model",
        "vocab_size": c.vocab_size,
        "hidden_size": c.hidden,
        "num_hidden_layers": c.layers,
        "num_attention_heads": c.heads,
        "intermediate_size": c.mlp,
        "max_position_embeddings": c.ctx,
        "layer_norm_eps": c.eps,
        "hidden_act": c.act,
    }
    if c.projection_dim:
        out["projection_dim"] = c.projection_dim
    return out


def _write_json(path: str, obj: dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def export_diffusers_checkpoint(params: dict, cfg, out_dir: str) -> str:
    """Write a diffusers ``save_pretrained`` directory of ``params`` (trees
    in the JAX layout: ``port_diffusers_checkpoint``'s, or
    ``pipeline_trees``') described by ``cfg`` (a ``PipelineConfig``).

    Each component in ``params`` becomes ``<comp>/*.safetensors`` (fp32:
    the JAX writer's safetensors-numpy has no bf16) and ``config.json``;
    ``scheduler/scheduler_config.json`` records the reference's PNDM
    construction and ``prediction_type``; ``model_index.json`` names the
    pipeline class.  The same files and JSON as the JAX package's
    ``export_diffusers_checkpoint`` (``_diffusers_version`` "0.7.2" for
    every family, as it writes); read back by
    ``port_diffusers_checkpoint`` and ``pipeline_config_from_diffusers``.
    Returns ``out_dir``."""
    layout = {
        "unet": (export_unet, _unet_config_to_diffusers(cfg.unet),
                 "diffusion_pytorch_model.safetensors"),
        "vae": (export_vae, _vae_config_to_diffusers(cfg.vae),
                "diffusion_pytorch_model.safetensors"),
        "text_encoder": (export_clip_text,
                         _clip_config_to_diffusers(cfg.clip),
                         "model.safetensors"),
    }
    if cfg.clip2 is not None:  # SDXL's second encoder
        layout["text_encoder_2"] = (export_clip_text,
                                    _clip_config_to_diffusers(cfg.clip2),
                                    "model.safetensors")
    index = {"_class_name": ("StableDiffusionXLImg2ImgPipeline" if cfg.refiner
                             else "StableDiffusionXLPipeline"
                             if cfg.clip2 is not None
                             else "StableDiffusionPipeline"),
             "_diffusers_version": "0.7.2",
             "scheduler": ["diffusers", "PNDMScheduler"],
             "safety_checker": [None, None],
             "feature_extractor": [None, None]}
    for comp, (exp, cjson, fname) in layout.items():
        if comp not in params:
            continue
        cdir = os.path.join(out_dir, comp)
        os.makedirs(cdir, exist_ok=True)
        write_safetensors({k: np.asarray(v, np.float32)
                           for k, v in exp(params[comp]).items()},
                          os.path.join(cdir, fname))
        _write_json(os.path.join(cdir, "config.json"), cjson)
        index[comp] = (["transformers", cjson["architectures"][0]]
                       if comp.startswith("text_encoder")
                       else ["diffusers", cjson["_class_name"]])
    sdir = os.path.join(out_dir, "scheduler")
    os.makedirs(sdir, exist_ok=True)
    s = cfg.schedule
    _write_json(os.path.join(sdir, "scheduler_config.json"), {
        "_class_name": "PNDMScheduler", "_diffusers_version": "0.7.2",
        "num_train_timesteps": s.num_train_timesteps,
        "beta_start": s.beta_start, "beta_end": s.beta_end,
        "beta_schedule": s.beta_schedule, "skip_prk_steps": True,
        "set_alpha_to_one": s.set_alpha_to_one,
        "steps_offset": s.steps_offset,
        "prediction_type": s.prediction_type})
    _write_json(os.path.join(out_dir, "model_index.json"), index)
    return out_dir


def module_jax_tree(module) -> dict:
    """A module's parameters as its tree in the JAX layout: nested dicts
    and lists of fp32 numpy copies on the host (stacked CLIP layers and
    deep-transformer blocks, the empty lists of blocks without
    attention)."""
    import torch

    from sdbc_tpu_torch.utils.checkpoint import EMPTY_LIST, module_tree

    root: dict = {}
    for key, t in module_tree(module):
        node = root
        for k, _ in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1][0]] = ([] if isinstance(t, str) and t == EMPTY_LIST
                            else t.detach().to("cpu", torch.float32,
                                               copy=True).numpy())

    def lists(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [lists(node[str(i)]) for i in range(len(node))]
            return {k: lists(v) for k, v in node.items()}
        return node

    return lists(root)


def pipeline_trees(pipe) -> dict:
    """The trees of an ``SDPipeline``'s components (or of a dict of its
    modules), in the JAX layout, for ``export_diffusers_checkpoint``;
    ControlNet branches are left out (``export_controlnet`` takes a
    branch's ``module_jax_tree``)."""
    models = getattr(pipe, "models", pipe)
    return {name: module_jax_tree(m) for name, m in models.items()
            if name != "controlnet"}


# ---------------------------------------------------------------------------
# BART (the summarizer)


def port_bart(sd: Dict[str, np.ndarray]) -> dict:
    """transformers ``BartForConditionalGeneration`` state dict →
    ``models.bart``'s tree; ``final_logits_bias`` is not read (the JAX
    package's ``port_bart`` ignores it too)."""
    def attn(pfx):
        return {"q": _linear(sd, f"{pfx}.q_proj"),
                "k": _linear(sd, f"{pfx}.k_proj"),
                "v": _linear(sd, f"{pfx}.v_proj"),
                "o": _linear(sd, f"{pfx}.out_proj")}

    def layer(pfx, cross):
        p = {"self_attn": attn(f"{pfx}.self_attn"),
             "self_ln": _norm(sd, f"{pfx}.self_attn_layer_norm"),
             "fc1": _linear(sd, f"{pfx}.fc1"),
             "fc2": _linear(sd, f"{pfx}.fc2"),
             "final_ln": _norm(sd, f"{pfx}.final_layer_norm")}
        if cross:
            p["cross_attn"] = attn(f"{pfx}.encoder_attn")
            p["cross_ln"] = _norm(sd, f"{pfx}.encoder_attn_layer_norm")
        return p

    def layers(side, cross):
        out, i = [], 0
        while f"model.{side}.layers.{i}.self_attn.q_proj.weight" in sd:
            out.append(layer(f"model.{side}.layers.{i}", cross))
            i += 1
        return out

    return {
        "shared_embedding": {"table": _f32(sd["model.shared.weight"])},
        "enc_pos": {"table": _f32(sd["model.encoder.embed_positions.weight"])},
        "dec_pos": {"table": _f32(sd["model.decoder.embed_positions.weight"])},
        "enc_ln_emb": _norm(sd, "model.encoder.layernorm_embedding"),
        "dec_ln_emb": _norm(sd, "model.decoder.layernorm_embedding"),
        "encoder": layers("encoder", cross=False),
        "decoder": layers("decoder", cross=True),
    }


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

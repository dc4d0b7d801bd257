"""Parameter partition specs: tensor parallelism and FSDP over the
``(data, model)`` mesh (counterpart of ``sdbc_tpu/parallel/specs.py``).

The rules and their layout are the JAX package's, copied as they are.
They apply to the port's parameters under their JAX key paths
(``models.convert.jax_key``): the port keeps the JAX layouts (HWIO
convolutions, ``(in, out)`` linears), so each spec's dims index the same
axes, and a stacked tree's leaf (CLIP's ``layers``, a deep transformer's
``blocks``) carries its leading layer axis as the JAX leaf does.

Layout (axis ``model`` = m-way):

  UNet spatial transformer   q/k/v column (heads split, m | heads),
                             o row (+psum); GEGLU up-proj row (contraction
                             split, +psum before the gate), ff_out column,
                             proj_out row (+psum).
  UNet ResBlocks             conv1/temb column over out-channels, GroupNorm
                             affine sharded with them (groups intact on a
                             shard when m | norm_groups), conv2 row over
                             in-channels (+psum).
  CLIP layers                q/k/v/fc1 column, o/fc2 row; the stacked
                             layer dim stays unsharded.
  VAE / embeddings / conv_in|out / time_mlp  replicated.

FSDP (axis ``data`` = n-way, ZeRO-3): every leaf of at least ``min_size``
elements is sharded on its first dim divisible by n that is not already
carrying ``model``.  Blockwise-int8 (8-bit AdamW) state is refused.

A spec here is a tuple over the leaf's dims (None, "model" or "data"),
``()`` for a replicated leaf: the JAX ``PartitionSpec`` as a tuple.  The
spec functions take ``{component: module}`` (a ControlNet component may be
a list of branches) and return ``{path: spec}``, the path the JAX
package's ``_path_str`` gives the same leaf ("unet/mid/attn/q/w").
"""
from __future__ import annotations

import re
from typing import Optional

import torch

# (path-suffix regex, spec template over the LAST len(template) dims)
_TP_RULES = (
    # attention: q/k/v column-parallel (splits heads), o row-parallel
    (r"attn[12]?/(q|k|v)/w$", (None, "model")),
    (r"attn[12]?/(q|k|v)/b$", ("model",)),
    (r"attn[12]?/o/w$", ("model", None)),
    # UNet GEGLU FF: row-parallel up-proj, column down-proj, row proj_out
    (r"geglu/w$", ("model", None)),
    (r"ff_out/w$", (None, "model")),
    (r"ff_out/b$", ("model",)),
    (r"proj_out/w$", (None, None, "model", None)),
    # CLIP MLP: Megatron column→row; segment-anchored so the UNet's
    # time_mlp stays replicated
    (r"(?:^|/)mlp/fc1/w$", (None, "model")),
    (r"(?:^|/)mlp/fc1/b$", ("model",)),
    (r"(?:^|/)mlp/fc2/w$", ("model", None)),
    # UNet ResBlock: conv1/temb column over cout, GN affine follows,
    # conv2 row over cin
    (r"resnet(s/\d+|[12])/conv1/w$", (None, None, None, "model")),
    (r"resnet(s/\d+|[12])/conv1/b$", ("model",)),
    (r"resnet(s/\d+|[12])/temb/w$", (None, "model")),
    (r"resnet(s/\d+|[12])/temb/b$", ("model",)),
    (r"resnet(s/\d+|[12])/norm2/(scale|bias)$", ("model",)),
    (r"resnet(s/\d+|[12])/conv2/w$", (None, None, "model", None)),
)

# components whose interior the TP rules may shard; anything else (vae,
# controlnet, ...) stays replicated even when a ResBlock rule would match
_TP_COMPONENTS = ("unet", "text_encoder", "text_encoder_2")


def _tp_spec_for(path: str, shape, m: int) -> Optional[tuple]:
    """Spec template (padded to leaf rank) for one leaf, or None."""
    wrapped = "/" + path + "/"
    in_component = any(f"/{c}/" in wrapped for c in _TP_COMPONENTS)
    if not in_component or m <= 1:
        return None
    for pat, tpl in _TP_RULES:
        if re.search(pat, path):
            if len(tpl) > len(shape):
                return None
            full = (None,) * (len(shape) - len(tpl)) + tuple(tpl)
            ok = all(t is None or (shape[i] % m == 0)
                     for i, t in enumerate(full))
            return full if ok else None
    return None


def _tensors(obj):
    """Every tensor of a tree: dicts, lists, tuples, modules, dataclasses
    (a train state and its optimizer state)."""
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif hasattr(obj, "__dataclass_fields__"):
        for k in obj.__dataclass_fields__:
            yield from _tensors(getattr(obj, k))


def _reject_int8_state(tree, what: str) -> None:
    """Refuse TP/FSDP over blockwise-int8 (8-bit AdamW) optimizer state:
    the fused update kernel updates whole 2048-element blocks of a whole
    leaf.  The finetune CLI refuses --use_8bit_adam with --tp/--fsdp up
    front; this guard covers library callers that build the state
    directly."""
    if any(t.dtype == torch.int8 for t in _tensors(tree)):
        raise ValueError(
            f"{what} cannot shard blockwise-int8 (adam8bit) optimizer "
            "state: the fused update kernel is an unpartitionable "
            "pallas_call. Use the standard fp32 AdamW (use_8bit_adam=False) "
            "with TP/FSDP — FSDP already removes the moment-memory "
            "motivation for int8 moments.")


def leaf_shapes(tree, component: Optional[str] = None) -> list:
    """[(path, JAX leaf shape)] of ``{component: module}`` (or of one
    component's module with ``component=`` its name), in module order; a
    stacked tree's layers count as one leaf with a leading layer axis."""
    from sdbc_tpu_torch.models.convert import jax_key, stacked

    if component is not None:
        tree = {component: tree}
    elif hasattr(tree, "trainable") and hasattr(tree, "frozen"):
        tree = {**tree.frozen, **tree.trainable}   # a train state
    out, index = [], {}
    for comp, value in tree.items():
        mods = (list(enumerate(value)) if isinstance(value, (list, tuple))
                else [(None, value)])
        for i, mod in mods:
            head = comp if i is None else f"{comp}/{i}"
            for name, p in list(mod.named_parameters()) + list(
                    mod.named_buffers()):
                key = jax_key(mod, name)
                path = head + "/" + "/".join(k for k, _ in key)
                if path in index:
                    out[index[path]][1][0] += 1
                    continue
                index[path] = len(out)
                shape = tuple(full_shape(p))
                out.append((path, [1, shape] if stacked(key) else [0, shape]))
    return [(path, (n,) + shape if n else shape) for path, (n, shape) in out]


def full_shape(p: torch.Tensor) -> tuple:
    """A parameter's shape before any sharding (``parallel.shard``)."""
    info = getattr(p, "_sdbc_shard", None)
    return tuple(p.shape) if info is None else info.shape


def tp_specs(tree, mesh_or_size, *, component: Optional[str] = None,
             exclude: tuple = ()) -> dict:
    """{path: spec} assigning the ``model`` axis Megatron-style.

    ``tree``: {component: module}, or one component's module with
    ``component=`` its name.  Leaves matching no rule, and any leaf whose
    dims don't divide by the axis size, are replicated, ().  ``exclude``
    names components to replicate wholesale (from ``validate_tp``)."""
    from sdbc_tpu_torch.parallel.mesh import mesh_shape

    m = (mesh_shape(mesh_or_size)["model"]
         if not isinstance(mesh_or_size, int) else mesh_or_size)
    if m > 1:
        _reject_int8_state(tree, "tp_specs")
    out = {}
    for p, shape in leaf_shapes(tree, component):
        if any(f"/{c}/" in f"/{p}/" for c in exclude):
            out[p] = ()
            continue
        tpl = _tp_spec_for(p, shape, m)
        out[p] = () if tpl is None else tuple(tpl)
    return out


def fsdp_specs(tree, mesh_or_size, *, base: Optional[dict] = None,
               min_size: int = 2 ** 12, component: Optional[str] = None
               ) -> dict:
    """{path: spec}: ZeRO-3 sharding over the ``data`` axis.

    Each leaf with at least ``min_size`` elements is sharded on its first
    dim divisible by the data-axis size that the ``base`` spec (e.g. a
    tp_specs dict) leaves free; small leaves stay replicated (or keep the
    base spec)."""
    from sdbc_tpu_torch.parallel.mesh import mesh_shape

    n = (mesh_shape(mesh_or_size)["data"]
         if not isinstance(mesh_or_size, int) else mesh_or_size)
    if n > 1:
        _reject_int8_state(tree, "fsdp_specs")
    out = {}
    for p, shape in leaf_shapes(tree, component):
        b = () if base is None else base[p]
        size = 1
        for s in shape:
            size *= s
        if n <= 1 or size < min_size:
            out[p] = tuple(b)
            continue
        tpl = tuple(b) + (None,) * (len(shape) - len(tuple(b)))
        out[p] = _add_axis_spec(tpl, shape, n)
    return out


def _add_axis_spec(tpl, shape, n, axis: str = "data"):
    tpl = tuple(tpl)
    for i, (t, s) in enumerate(zip(tpl, shape)):
        if t is None and s % n == 0:
            lst = list(tpl)
            lst[i] = axis
            return tuple(lst)
    return tuple(tpl) if any(t is not None for t in tpl) else ()


def validate_tp(cfg, m: int) -> tuple:
    """Check architecture/mesh alignment the per-leaf divisibility check
    can't see (head splits, GroupNorm group alignment).

    Raises when the UNet can't shard cleanly.  A misaligned text encoder
    is NOT an error: it returns ``("text_encoder",)`` so callers pass it
    to ``tp_specs(exclude=...)`` and replicate CLIP instead (e.g. SD-1.5
    at m=8: UNet heads 8 shard, CLIP heads 12 don't).  Returns the tuple
    of component names to exclude (possibly empty)."""
    if m <= 1:
        return ()
    u, c = cfg.unet, cfg.clip
    # only levels that HAVE attention constrain the head split
    attn_heads = [h for h, has in zip(u.heads_per_level, u.cross_attn_blocks)
                  if has]
    attn_heads.append(u.heads_per_level[-1])  # the mid transformer's
    if any(h % m for h in attn_heads):
        raise ValueError(f"model axis {m} must divide the UNet head count "
                         f"at every attention level ({tuple(attn_heads)})")
    if u.norm_groups % m:
        raise ValueError(f"model axis {m} must divide UNet norm_groups "
                         f"{u.norm_groups} (keeps GroupNorm groups intact "
                         f"per shard)")
    excl = ("text_encoder",) if c.heads % m else ()
    c2 = getattr(cfg, "clip2", None)
    if c2 is not None and c2.heads % m:
        excl += ("text_encoder_2",)
    return excl

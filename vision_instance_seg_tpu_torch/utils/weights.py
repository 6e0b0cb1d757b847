"""JAX parameter tree -> the port's (upstream detectron2 layout) state dict.

``state_dict_from_jax`` inverts the JAX package's checkpoint import
(``vision_instance_seg_tpu/utils/weights.py``: the Swin and ResNet key maps,
the pixel-decoder, Mask2Former- and MaskDINO-predictor maps and the scan
restacking), so one set of weights runs in both packages:

- Dense kernels (in, out) become Linear weights (out, in); a Dense that
  upstream holds as a 1x1 conv becomes (out, in, 1, 1);
- Conv kernels HWIO become OIHW; LayerNorm/GroupNorm ``scale`` -> ``weight``;
- the q/k/v Denses of the predictor's attention layers are concatenated
  into ``in_proj_weight`` / ``in_proj_bias`` (``nn.MultiheadAttention``);
  the window encoder keeps its ``q_proj`` / ``k_proj`` / ``v_proj``;
- scanned stacks are split: ``encoder_layers/layer/*`` (leading axis = the
  encoder layers), the window encoder's ``wenc_layers/block{0,1}/*`` and
  Swin's ``stage{s}_blocks/block{0,1}/*`` (leading axis = the (regular,
  shifted) pairs, so pair i, block j is layer / block 2i + j);
- the ResNet's FrozenBN statistics, in JAX's ``frozen`` collection
  (``<block>/<conv>_norm/{scale, bias, mean, var}``), become the buffers
  ``<conv>.norm.{weight, bias, running_mean, running_var}``;
- MaskDINO's extra pixel-decoder levels ``input_proj_ds{k}`` follow the
  backbone levels in ``input_proj`` (upstream's [res5, res4, res3, ds0]);
  its decoder layers swap JAX's ``norm1`` / ``norm2`` into upstream's
  ``norm2`` / ``norm1``; its separate two-stage heads keep their own
  names (``enc_class_embed``, ``enc_box_embed``; see
  ``models/maskdino_decoder.py``).

The JAX tree comes as nested dicts of numpy arrays: ``params``, or the full
variables ``{"params": ..., "frozen": ...}`` (a ResNet needs the second).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _flatten(tree: Any, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    if hasattr(tree, "items"):
        out: Dict[Path, np.ndarray] = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree, np.float32)}


def _unstack(flat: Dict[Path, np.ndarray]) -> Dict[Path, np.ndarray]:
    """Split scanned parameter stacks into per-layer / per-block entries."""
    out: Dict[Path, np.ndarray] = {}
    for path, v in flat.items():
        m = re.fullmatch(r"stage(\d+)_blocks", path[0])
        if m and path[1] in ("block0", "block1"):
            j = int(path[1][-1])
            for i in range(v.shape[0]):
                out[(f"stage{m.group(1)}_block{2 * i + j}",) + path[2:]] = v[i]
        elif path[0] == "wenc_layers" and path[1] in ("block0", "block1"):
            j = int(path[1][-1])
            for i in range(v.shape[0]):
                out[(f"encoder_layer{2 * i + j}",) + path[2:]] = v[i]
        elif path[:2] == ("encoder_layers", "layer"):
            for i in range(v.shape[0]):
                out[(f"encoder_layer{i}",) + path[2:]] = v[i]
        else:
            out[path] = v
    return out


def _backbone_name(mod: str) -> str:
    """Swin or ResNet module path -> upstream name."""
    if mod == "stem_conv1":
        return "stem.conv1"
    if mod == "stem_norm":
        return "stem.conv1.norm"
    if m := re.fullmatch(r"res(\d)_block(\d+)/(conv\d|shortcut)(_norm)?",
                         mod):
        return f"res{m[1]}.{m[2]}.{m[3]}" + (".norm" if m[4] else "")
    return _swin_name(mod)


def _swin_name(mod: str) -> str:
    if mod == "patch_embed":
        return "patch_embed.proj"
    if mod == "patch_norm":
        return "patch_embed.norm"
    if m := re.fullmatch(r"stage(\d+)_block(\d+)/(.+)", mod):
        return f"layers.{m[1]}.blocks.{m[2]}.{m[3]}"
    if m := re.fullmatch(r"downsample(\d+)/(.+)", mod):
        return f"layers.{m[1]}.downsample.{m[2]}"
    if re.fullmatch(r"norm\d+", mod):
        return mod
    raise KeyError(f"unmapped backbone parameter {mod}")


def _pixel_decoder_name(mod: str, fpn_index: Dict[str, int],
                        n_tf: int) -> str:
    """``n_tf``: the backbone levels, after which the extra levels
    (``input_proj_ds{k}``) sit in ``input_proj``."""
    if m := re.fullmatch(r"input_proj(\d+)(_norm)?", mod):
        return f"input_proj.{m[1]}." + ("1" if m[2] else "0")
    if m := re.fullmatch(r"input_proj_ds(\d+)(_norm)?", mod):
        return f"input_proj.{n_tf + int(m[1])}." + ("1" if m[2] else "0")
    if m := re.fullmatch(r"encoder_layer(\d+)(/.+)?", mod):
        return f"transformer.encoder.layers.{m[1]}{m[2] or ''}"
    if m := re.fullmatch(r"(lateral|output)_(res\d)(_norm)?", mod):
        kind = "lateral_convs" if m[1] == "lateral" else "output_convs"
        return f"{kind}.{fpn_index[m[2]]}" + (".norm" if m[3] else "")
    if mod == "mask_features":
        return mod
    raise KeyError(f"unmapped pixel-decoder parameter {mod}")


def _predictor_name(mod: str) -> str:
    if m := re.fullmatch(r"mask_embed/layer(\d+)", mod):
        return f"mask_embed.layers.{m[1]}"
    if m := re.fullmatch(r"layer(\d+)_cross_attn/(.+)", mod):
        return f"transformer_cross_attention_layers.{m[1]}.multihead_attn.{m[2]}"
    if m := re.fullmatch(r"layer(\d+)_self_attn/(.+)", mod):
        return f"transformer_self_attention_layers.{m[1]}.self_attn.{m[2]}"
    if m := re.fullmatch(r"layer(\d+)_norm(\d)", mod):
        kind = {"1": "transformer_cross_attention_layers",
                "2": "transformer_self_attention_layers",
                "3": "transformer_ffn_layers"}[m[2]]
        return f"{kind}.{m[1]}.norm"
    if m := re.fullmatch(r"layer(\d+)_ffn(\d)", mod):
        return f"transformer_ffn_layers.{m[1]}.linear{m[2]}"
    if re.fullmatch(r"input_proj\d+", mod):
        return f"input_proj.{mod[len('input_proj'):]}"
    if mod in ("decoder_norm", "class_embed"):
        return mod
    raise KeyError(f"unmapped predictor parameter {mod}")


# JAX MaskDINO layer{i}_norm{k} -> upstream norm: self-attention (JAX norm1)
# is upstream norm2, cross-attention (JAX norm2) upstream norm1
_DINO_NORMS = {"1": "norm2", "2": "norm1", "3": "norm3"}


def _maskdino_name(mod: str) -> str:
    if m := re.fullmatch(r"(mask_embed|enc_box_embed|box_embed|"
                         r"ref_point_head)/layer(\d+)", mod):
        head = {"box_embed": "decoder.bbox_embed.0",
                "ref_point_head": "decoder.ref_point_head"}.get(m[1], m[1])
        return f"{head}.layers.{m[2]}"
    if m := re.fullmatch(r"layer(\d+)_(self_attn|cross_attn)/(.+)", mod):
        return f"decoder.layers.{m[1]}.{m[2]}.{m[3]}"
    if m := re.fullmatch(r"layer(\d+)_norm(\d)", mod):
        return f"decoder.layers.{m[1]}.{_DINO_NORMS[m[2]]}"
    if m := re.fullmatch(r"layer(\d+)_ffn(\d)", mod):
        return f"decoder.layers.{m[1]}.linear{m[2]}"
    if mod == "decoder_norm":
        return "decoder.norm"
    if mod in ("class_embed", "enc_class_embed", "enc_output",
               "enc_output_norm"):
        return mod
    raise KeyError(f"unmapped MaskDINO predictor parameter {mod}")


_ROOT_LEAVES = {
    ("pixel_decoder", "level_embed"): "transformer.level_embed",
    ("predictor", "query_feat"): "query_feat.weight",
    ("predictor", "query_embed"): "query_embed.weight",
    ("predictor", "level_embed"): "level_embed.weight",
    ("predictor", "dn_label_enc"): "label_enc.weight",
    ("predictor", "query_box"): "refpoint_embed.weight",
}
_FROZEN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}
_CONV1X1 = re.compile(r"(input_proj\.\d+(\.0)?|lateral_convs\.\d+)")
_PREFIX = {"backbone": "backbone.",
           "pixel_decoder": "sem_seg_head.pixel_decoder.",
           "predictor": "sem_seg_head.predictor."}


def _leaf(leaf: str, v: np.ndarray, conv1x1: bool) -> Tuple[str, np.ndarray]:
    if leaf == "kernel":
        if v.ndim == 4:                               # HWIO -> OIHW
            return "weight", v.transpose(3, 2, 0, 1)
        w = v.T                                       # (in, out) -> (out, in)
        return "weight", w[:, :, None, None] if conv1x1 else w
    if leaf == "scale":
        return "weight", v
    return leaf, v


def state_dict_from_jax(variables: Any) -> Dict[str, torch.Tensor]:
    """Map a JAX Mask2Former or MaskDINO (Swin or ResNet) parameter tree, or
    its full variables with the ``frozen`` collection, onto the port's
    ``state_dict`` names; the result loads with ``strict=True``."""
    params = variables.get("params", variables)
    sd: Dict[str, np.ndarray] = {}
    for path, v in _flatten(variables.get("frozen", {})).items():
        if path[0] != "backbone":
            raise KeyError(f"unmapped frozen variable {'/'.join(path)}")
        name = _backbone_name("/".join(path[1:-1]))
        sd[f"backbone.{name}.{_FROZEN_LEAVES[path[-1]]}"] = v
    dino = "enc_output" in params["predictor"]
    for sub, prefix in _PREFIX.items():
        flat = _unstack(_flatten(params[sub]))
        fpn = sorted({m[1] for p in flat
                      if (m := re.fullmatch(r"lateral_(res\d)", p[0]))},
                     reverse=True)                    # coarsest first
        fpn_index = {n: k for k, n in enumerate(fpn)}
        n_tf = len({p[0] for p in flat
                    if re.fullmatch(r"input_proj\d+", p[0])})
        qkv: Dict[Tuple[str, str], Dict[str, np.ndarray]] = {}
        for path, v in flat.items():
            if len(path) == 1:
                sd[prefix + _ROOT_LEAVES[(sub, path[0])]] = v
                continue
            mod, leaf = "/".join(path[:-1]), path[-1]
            if sub == "backbone":
                name = _backbone_name(mod)
            elif sub == "pixel_decoder":
                name = _pixel_decoder_name(mod, fpn_index, n_tf)
            elif dino:
                name = _maskdino_name(mod)
            else:
                name = _predictor_name(mod)
            name = name.replace("/", ".")
            key, val = _leaf(leaf, v, bool(_CONV1X1.fullmatch(name)))
            m = re.fullmatch(r"(.+)\.([qkv])_proj", name)
            if m and sub == "predictor":   # -> MultiheadAttention in_proj_*
                qkv.setdefault((m[1], key), {})[m[2]] = val
                continue
            sd[f"{prefix}{name}.{key}"] = val
        for (attn, key), parts in qkv.items():
            sd[f"{prefix}{attn}.in_proj_{key}"] = np.concatenate(
                [parts["q"], parts["k"], parts["v"]], axis=0)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}

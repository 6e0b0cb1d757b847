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
  ``models/maskdino_decoder.py``); the dense cross-attention's
  ``layer{i}_cross_attn`` q/k/v fold into ``in_proj_*`` as the
  self-attention's do, and its ``kpos_level_embed``,
  ``layer{i}_xattn_log_sigma`` and ``geo_box_head`` become
  ``kpos_level_embed``, ``decoder.layers.{i}.xattn_log_sigma`` and
  ``decoder.geo_box_head``;
- Swin's ``absolute_pos_embed`` (1, P, P, C) becomes the detection fork's
  (1, C, P, P).

The JAX tree comes as nested dicts of numpy arrays: ``params``, or the full
variables ``{"params": ..., "frozen": ...}`` (a ResNet needs the second).
"""

from __future__ import annotations

import logging
import pickle
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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
                         r"ref_point_head|geo_box_head)/layer(\d+)", mod):
        head = {"box_embed": "decoder.bbox_embed.0",
                "ref_point_head": "decoder.ref_point_head",
                "geo_box_head": "decoder.geo_box_head"}.get(m[1], m[1])
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
    ("backbone", "absolute_pos_embed"): "absolute_pos_embed",
    ("pixel_decoder", "level_embed"): "transformer.level_embed",
    ("predictor", "query_feat"): "query_feat.weight",
    ("predictor", "query_embed"): "query_embed.weight",
    ("predictor", "level_embed"): "level_embed.weight",
    ("predictor", "dn_label_enc"): "label_enc.weight",
    ("predictor", "query_box"): "refpoint_embed.weight",
    ("predictor", "kpos_level_embed"): "kpos_level_embed",
}


def _root_leaf(sub: str, leaf: str) -> str:
    """A parameter at the root of a JAX sub-tree -> its port name; the
    dense MaskDINO layers' ``layer{i}_xattn_log_sigma`` sit on the port's
    decoder layers."""
    if sub == "predictor" and (
            m := re.fullmatch(r"layer(\d+)_xattn_log_sigma", leaf)):
        return f"decoder.layers.{m[1]}.xattn_log_sigma"
    return _ROOT_LEAVES[(sub, leaf)]
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
                if path[0] == "absolute_pos_embed":     # NHWC -> NCHW
                    v = v.transpose(0, 3, 1, 2)
                sd[prefix + _root_leaf(sub, path[0])] = v
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


# --------------------------------------------------------------------------
# Checkpoint import: torch / detectron2 files -> the port's model
#
# The port's own counterpart of the JAX package's ``utils/weights.py``
# (``load_torch_state``, the Swin and ResNet key maps, the rel-pos table
# resize, ``import_backbone_weights``, ``import_full_model_weights`` and
# ``check_sampling_offset_halo``). The port's names are the upstream
# detectron2 layout, so every map below is a renaming of keys, and most keys
# keep their names; tensors keep their torch layout. Which keys are taken,
# dropped, duplicated or resized, and what counts as consumed, follow the
# JAX maps key for key: one file gives both packages the same weights.
# ``applied`` counts the port's tensors written.

logger = logging.getLogger(__name__)

State = Dict[str, np.ndarray]


def load_torch_state(path: str) -> State:
    """A .pth / .pt (torch) or .pkl (detectron2) checkpoint as numpy
    arrays: a .pkl's ``model`` dict (its numpy leaves), a torch file
    unwrapped from ``model``, ``state_dict`` and ``module`` in turn. A
    torch file is read with ``weights_only=True``: tensors and plain
    containers only, so a file cannot run code on load."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        state = data.get("model", data)
        return {k: np.asarray(v) for k, v in state.items()
                if isinstance(v, np.ndarray)}
    try:
        data = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: holds objects other than tensors and plain containers, "
            "which torch.load(weights_only=True) refuses to unpickle; save "
            "its state dict alone") from e
    for key in ("model", "state_dict", "module"):
        if isinstance(data, dict) and key in data:
            data = data[key]
    return {k: v.detach().numpy() for k, v in data.items()
            if hasattr(v, "detach")}


def _swin_key(k: str) -> Optional[str]:
    """timm / microsoft Swin key -> the port's name, or None for what the
    JAX map drops: the classifier (``head.``, ``norm.``), ``attn_mask``,
    ``relative_position_index`` and anything it does not name."""
    if k.startswith(("head.", "norm.")) or k.endswith("attn_mask") \
            or "relative_position_index" in k:
        return None
    if re.fullmatch(r"norm\d\.(weight|bias)", k) \
            or k == "absolute_pos_embed" or re.fullmatch(
                r"patch_embed\.(proj|norm)\.(weight|bias)", k):
        return k
    if re.fullmatch(r"layers\.\d+\.blocks\.\d+\.(norm\d\.(weight|bias)|"
                    r"attn\.relative_position_bias_table|"
                    r"attn\.(qkv|proj)\.(weight|bias)|"
                    r"mlp\.fc\d\.(weight|bias))", k):
        return k
    if re.fullmatch(r"layers\.\d+\.downsample\.(reduction\.weight|"
                    r"norm\.(weight|bias))", k):
        return k
    return None


_BN_STATS = r"(weight|bias|running_mean|running_var)"


def _resnet_key(k: str) -> Optional[str]:
    """torchvision or detectron2 ResNet key -> the port's (detectron2)
    name, or None (``fc.``, ``num_batches_tracked``, unnamed keys)."""
    k = k.replace("backbone.bottom_up.", "")
    if k.startswith("fc.") or "num_batches_tracked" in k:
        return None
    if k in ("conv1.weight", "stem.conv1.weight"):
        return "stem.conv1.weight"
    if m := re.fullmatch(rf"(?:bn1|stem\.conv1\.norm)\.{_BN_STATS}", k):
        return f"stem.conv1.norm.{m[1]}"
    if m := re.fullmatch(r"layer(\d)\.(\d+)\.conv(\d)\.weight", k):
        return f"res{int(m[1]) + 1}.{m[2]}.conv{m[3]}.weight"
    if m := re.fullmatch(rf"layer(\d)\.(\d+)\.bn(\d)\.{_BN_STATS}", k):
        return f"res{int(m[1]) + 1}.{m[2]}.conv{m[3]}.norm.{m[4]}"
    if m := re.fullmatch(r"layer(\d)\.(\d+)\.downsample\.0\.weight", k):
        return f"res{int(m[1]) + 1}.{m[2]}.shortcut.weight"
    if m := re.fullmatch(rf"layer(\d)\.(\d+)\.downsample\.1\.{_BN_STATS}",
                         k):
        return f"res{int(m[1]) + 1}.{m[2]}.shortcut.norm.{m[3]}"
    if re.fullmatch(rf"res\d\.\d+\.(conv\d|shortcut)(\.weight|"
                    rf"\.norm\.{_BN_STATS})", k):
        return k
    return None


def _backbone_map(state: State) -> State:
    """A Swin (``layers.0.blocks.*``) or ResNet backbone file -> the port's
    backbone names."""
    is_swin = any(k.startswith("layers.0.blocks.") for k in state)
    name = _swin_key if is_swin else _resnet_key
    return {n: v for k, v in state.items() if (n := name(k)) is not None}


def _resize_rel_pos_table(v: np.ndarray, want_len: int) -> np.ndarray:
    """Bicubic resize (``align_corners=False``) of a flattened
    ((2w - 1)^2, nH) relative-position-bias table to another window size,
    the microsoft Swin ``load_pretrained`` convention: window-7 ImageNet
    checkpoints into window-8 or window-12 models."""
    l0, nh = v.shape
    s0, s1 = int(round(l0 ** 0.5)), int(round(want_len ** 0.5))
    if s0 * s0 != l0 or s1 * s1 != want_len:
        raise ValueError(f"relative_position_bias_table lengths not square: "
                         f"ckpt {l0} -> model {want_len}")
    t = torch.from_numpy(np.asarray(v, np.float32))
    t = t.reshape(s0, s0, nh).permute(2, 0, 1).unsqueeze(0)
    t = F.interpolate(t, size=(s1, s1), mode="bicubic", align_corners=False)
    return t.squeeze(0).permute(1, 2, 0).reshape(want_len, nh).numpy()


def _fit_rel_pos(v: np.ndarray, want_shape) -> np.ndarray:
    if v.ndim == 2 and len(want_shape) == 2 and v.shape[1] == want_shape[1]:
        return _resize_rel_pos_table(v, int(want_shape[0]))
    raise ValueError(f"cannot fit relative_position_bias_table {v.shape} "
                     f"to model shape {tuple(want_shape)}")


@torch.no_grad()
def _deep_update(target: Dict[str, torch.Tensor], src: State) -> int:
    """Copy each ``src`` array into the ``target`` tensor of its name
    (names the model lacks are skipped); a shape mismatch raises, except on
    a relative-position-bias table, which is resized. Returns the number of
    tensors written."""
    n = 0
    for k, v in src.items():
        if k not in target:
            continue
        cur = target[k]
        if tuple(cur.shape) != tuple(v.shape):
            if not k.endswith("relative_position_bias_table"):
                raise ValueError(f"shape mismatch at {k}: ckpt {v.shape} vs "
                                 f"model {tuple(cur.shape)}")
            v = _fit_rel_pos(np.asarray(v), cur.shape)
        cur.copy_(torch.from_numpy(np.asarray(v, np.float32)))
        n += 1
    return n


def import_backbone_weights(path: str, model: nn.Module) -> int:
    """Load a torch / detectron2 backbone file (an ImageNet Swin or ResNet)
    into ``model``'s backbone (``model.backbone``, or ``model`` itself when
    it is a bare backbone), in place. Returns the tensors written; a file
    of which nothing matches raises."""
    state = load_torch_state(path)
    backbone = getattr(model, "backbone", model)
    applied = _deep_update(backbone.state_dict(), _backbone_map(state))
    logger.info("imported %d arrays from %s", applied, path)
    if applied == 0:
        raise ValueError(f"no weights matched from {path}")
    return applied


class _Mapper:
    """Accumulates (port name -> array) writes and the consumed keys."""

    def __init__(self, state: State):
        self.state = state
        self.consumed: set = set()
        self.out: State = {}

    def take(self, key: str, *names: str) -> None:
        """Consume ``key`` (when present) into ``names`` (default: its own
        name, the upstream layout's)."""
        if key in self.state:
            self.consumed.add(key)
            for name in names or (key,):
                self.out[name] = self.state[key]

    def params(self, key: str, *names: str,
               leaves=("weight", "bias")) -> None:
        for leaf in leaves:
            self.take(f"{key}.{leaf}", *(f"{n}.{leaf}" for n in names))

    def mlp(self, key: str, *names: str, n_layers: int = 3) -> None:
        for j in range(n_layers):
            self.params(f"{key}.layers.{j}",
                        *(f"{n}.layers.{j}" for n in names))

    def mha(self, key: str) -> None:
        self.params(key, leaves=("in_proj_weight", "in_proj_bias"))
        self.params(f"{key}.out_proj")

    def deform_attn(self, key: str) -> None:
        for sub in ("sampling_offsets", "attention_weights", "value_proj",
                    "output_proj"):
            self.params(f"{key}.{sub}")


def _strip_prefix(state: State, prefix: str) -> State:
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def _map_pixel_decoder(state: State) -> _Mapper:
    """``sem_seg_head.pixel_decoder.*``: the input projections (d2 order
    [res5, res4, res3, extra levels]), the level embedding, the deformable
    encoder layers, the FPN's res2 lateral and output convs and
    ``mask_features``."""
    m = _Mapper(state)
    n_proj = 1 + max([-1] + [int(r[1]) for k in state
                             if (r := re.match(r"input_proj\.(\d+)\.", k))])
    for i in range(n_proj):
        m.params(f"input_proj.{i}.0")
        m.params(f"input_proj.{i}.1")
    m.take("transformer.level_embed")
    li = 0
    while f"transformer.encoder.layers.{li}.norm1.weight" in state:
        base = f"transformer.encoder.layers.{li}"
        m.deform_attn(f"{base}.self_attn")
        for sub in ("norm1", "linear1", "linear2", "norm2"):
            m.params(f"{base}.{sub}")
        li += 1
    for key in ("lateral_convs.0", "lateral_convs.0.norm", "output_convs.0",
                "output_convs.0.norm", "mask_features"):
        m.params(key)
    return m


def _map_maskdino_predictor(state: State) -> _Mapper:
    """``sem_seg_head.predictor.*``, MaskDINO layout: upstream's shared
    ``class_embed`` and box MLP (``decoder.bbox_embed.0``) fill both the
    decoder's heads and the two-stage ``enc_class_embed`` /
    ``enc_box_embed``; the other ``bbox_embed.{i}`` alias the same tensors
    and are consumed unread."""
    m = _Mapper(state)
    m.params("class_embed", "class_embed", "enc_class_embed")
    m.mlp("decoder.bbox_embed.0", "decoder.bbox_embed.0", "enc_box_embed")
    m.consumed |= {k for k in state
                   if re.match(r"decoder\.bbox_embed\.\d+\.", k)}
    m.mlp("mask_embed")
    for key in ("label_enc.weight", "query_feat.weight",
                "refpoint_embed.weight"):
        m.take(key)
    for key in ("enc_output", "enc_output_norm", "decoder.norm"):
        m.params(key)
    m.mlp("decoder.ref_point_head", n_layers=2)
    li = 0
    while f"decoder.layers.{li}.norm1.weight" in state:
        base = f"decoder.layers.{li}"
        m.deform_attn(f"{base}.cross_attn")
        m.mha(f"{base}.self_attn")
        for sub in ("norm2", "norm1", "norm3", "linear1", "linear2"):
            m.params(f"{base}.{sub}")
        li += 1
    return m


def _map_mask2former_predictor(state: State) -> _Mapper:
    """``sem_seg_head.predictor.*``, Mask2Former layout."""
    m = _Mapper(state)
    for name in ("query_feat", "query_embed", "level_embed"):
        m.take(f"{name}.weight")
    m.params("class_embed")
    m.mlp("mask_embed")
    m.params("decoder_norm")
    i = 0
    while f"input_proj.{i}.weight" in state:
        m.params(f"input_proj.{i}")
        i += 1
    li = 0
    while f"transformer_self_attention_layers.{li}.norm.weight" in state:
        m.mha(f"transformer_cross_attention_layers.{li}.multihead_attn")
        m.params(f"transformer_cross_attention_layers.{li}.norm")
        m.mha(f"transformer_self_attention_layers.{li}.self_attn")
        m.params(f"transformer_self_attention_layers.{li}.norm")
        for sub in ("linear1", "linear2", "norm"):
            m.params(f"transformer_ffn_layers.{li}.{sub}")
        li += 1
    return m


def _identity_init_missing_input_proj(predictor: Dict[str, torch.Tensor],
                                      mapped: State) -> None:
    """Mask2Former's ``input_proj`` is an empty Sequential when the pixel
    decoder's width equals the decoder's (no checkpoint keys): the port's
    1x1 conv then takes the identity."""
    for k, v in predictor.items():
        if (m := re.fullmatch(r"(input_proj\.\d+)\.weight", k)) \
                and k not in mapped and v.shape[0] == v.shape[1]:
            eye = np.eye(v.shape[0], dtype=np.float32)
            mapped[k] = eye.reshape(tuple(v.shape))
            mapped[f"{m[1]}.bias"] = np.zeros(v.shape[0], np.float32)


def check_sampling_offset_halo(state: State) -> float:
    """The largest |sampling offset bias| in sampled-level pixels, with a
    warning when it passes the sampling kernels' ``DEFAULT_HALO``: under
    ``TPU.USE_PALLAS_DEFORM_ATTN`` the encoder clamps its offsets there,
    so such a checkpoint runs clamped."""
    from vision_instance_seg_tpu_torch.kernels.msdeform_attn import (
        DEFAULT_HALO)

    worst = 0.0
    for k, v in state.items():
        if k.endswith("sampling_offsets.bias"):
            worst = max(worst, float(np.abs(v).max()))
    if worst > DEFAULT_HALO:
        logger.warning(
            "checkpoint sampling-offset bias reaches %.1f px > halo %d: "
            "offsets will be clamped to the halo at runtime (exact kernel "
            "semantics, but not identical to the unclamped torch model)",
            worst, DEFAULT_HALO)
    return worst


_IGNORABLE = re.compile(r"(criterion\.|pixel_mean|pixel_std|"
                        r"num_batches_tracked)")


def import_full_model_weights(path: str, model: nn.Module) -> Dict:
    """Import a complete detectron2-layout MaskDINO or Mask2Former
    checkpoint into ``model``, in place (what the reference loads at
    evaluate.py:113-115). Returns the report: ``consumed`` / ``total``
    checkpoint keys, ``applied`` (the port's tensors written) and the
    ``unmapped`` keys (criterion buffers, pixel mean / std and BN counters
    aside)."""
    state = load_torch_state(path)
    target = model.state_dict()
    consumed: set = set()
    applied = 0
    bb = _strip_prefix(state, "backbone.")
    if bb and hasattr(model, "backbone"):
        applied += _deep_update(model.backbone.state_dict(),
                                _backbone_map(bb))
        consumed |= {"backbone." + k for k in bb}
    for part, mapper in (("pixel_decoder", _map_pixel_decoder),
                         ("predictor", None)):
        prefix = f"sem_seg_head.{part}."
        sub = _strip_prefix(state, prefix)
        if not sub or not any(k.startswith(prefix) for k in target):
            continue
        own = _strip_prefix(target, prefix)
        if mapper is None:
            dino = any(k.startswith("decoder.layers.") for k in sub)
            mapper = (_map_maskdino_predictor if dino
                      else _map_mask2former_predictor)
        mp = mapper(sub)
        if mapper is _map_mask2former_predictor:
            _identity_init_missing_input_proj(own, mp.out)
        applied += _deep_update(own, mp.out)
        consumed |= {prefix + k for k in mp.consumed}
    check_sampling_offset_halo(state)
    unmapped = sorted(k for k in state
                      if k not in consumed and not _IGNORABLE.search(k))
    report = {"consumed": len(consumed), "total": len(state),
              "applied": applied, "unmapped": unmapped}
    logger.info("full import from %s: %d/%d d2 keys consumed, %d arrays "
                "written, %d unmapped", path, len(consumed), len(state),
                applied, len(unmapped))
    if unmapped:
        logger.warning("unmapped checkpoint keys: %s",
                       ", ".join(unmapped[:20]))
    return report

"""Model FLOPs of one image from the configuration's shapes.

``products`` counts every matrix product and convolution the forward
runs, as ``torch.utils.flop_counter`` counts them (2 x multiply-adds,
biases and norms left out, Swin's windows on the padded map);
``sampling`` the deformable sampling, 10 flops per (query, head, channel,
level, point) as the kernels' bound counts it. Training is the forward
with every decoder layer's masks (deep supervision) and its backward,
counted as twice the forward's products and the sampling backward's 16
flops; recomputation is never counted."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from benchmark.reference.heads import ENCODER_FFN


def _out(h: int, k: int, s: int, p: int) -> int:
    return (h + 2 * p - k) // s + 1


def _lin(tokens: int, cin: int, cout: int) -> float:
    return 2.0 * tokens * cin * cout


def swin(s: dict, h: int, w: int) -> Tuple[float, Dict[str, Tuple]]:
    ps, c = s["PATCH_SIZE"], s["EMBED_DIM"]
    h, w = math.ceil(h / ps), math.ceil(w / ps)
    f = _lin(h * w, 3 * ps * ps, c)
    ws = s["WINDOW_SIZE"]
    maps = {}
    for i, depth in enumerate(s["DEPTHS"]):
        dim = c * 2 ** i
        hp, wp = math.ceil(h / ws) * ws, math.ceil(w / ws) * ws
        per_block = (_lin(hp * wp, dim, 3 * dim) + _lin(hp * wp, dim, dim)
                     + 4.0 * hp * wp * ws * ws * dim
                     + _lin(h * w, dim, int(dim * s["MLP_RATIO"])) * 2)
        f += depth * per_block
        maps[f"res{i + 2}"] = (h, w, dim)
        if i < len(s["DEPTHS"]) - 1:
            h, w = math.ceil(h / 2), math.ceil(w / 2)
            f += _lin(h * w, 4 * dim, 2 * dim)
    return f, maps


def resnet(r: dict, h: int, w: int) -> Tuple[float, Dict[str, Tuple]]:
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
    stem = r["STEM_OUT_CHANNELS"]
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    f = 2.0 * h * w * 3 * 49 * stem
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin, maps = stem, {}
    for i, n in enumerate(blocks[r["DEPTH"]]):
        cout, mid = 256 << i, 64 << i
        for j in range(n):
            st = 2 if j == 0 and i > 0 else 1
            h, w = _out(h, 1, st, 0), _out(w, 1, st, 0)
            f += (_lin(h * w, cin, mid) + 9 * _lin(h * w, mid, mid)
                  + _lin(h * w, mid, cout))
            if cin != cout or st != 1:
                f += _lin(h * w, cin, cout)
            cin = cout
        maps[f"res{i + 2}"] = (h, w, cout)
    return f, maps


def _msda(q: int, s: int, c: int, nh: int, nl: int, p: int
          ) -> Tuple[float, float]:
    n = nh * nl * p
    prod = (_lin(s, c, c) + _lin(q, c, 2 * n) + _lin(q, c, n)
            + _lin(q, c, c))
    return prod, 10.0 * q * c * nl * p


def pixel_decoder(sh: dict, maps: Dict[str, Tuple]
                  ) -> Tuple[float, float, List[Tuple[int, int]], Tuple]:
    c = sh["CONVS_DIM"]
    tf = list(sh["DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES"])[::-1]
    f = sum(_lin(maps[n][0] * maps[n][1], maps[n][2], c) for n in tf)
    levels = [maps[n][:2] for n in tf]
    extra = []
    h, w, cin = maps[tf[0]]
    for _ in range(int(sh["TOTAL_NUM_FEATURE_LEVELS"]) - len(tf)):
        h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
        f += 9 * _lin(h * w, cin, c)
        cin = c
        extra.insert(0, (h, w))
    levels = extra + levels
    nl = len(levels)
    s = sum(h * w for h, w in levels)
    prod, samp = _msda(s, s, c, sh["DEFORM_NUM_HEADS"], nl,
                       sh["DEFORM_NUM_POINTS"])
    layers = sh["TRANSFORMER_ENC_LAYERS"]
    f += layers * (prod + 2 * _lin(s, c, ENCODER_FFN))
    sampling = layers * samp
    fpn = [n for n in ("res2", "res3", "res4", "res5") if n not in tf][::-1]
    for n in fpn:
        h, w, cin = maps[n]
        f += _lin(h * w, cin, c) + 9 * _lin(h * w, c, c)
    h, w = maps[fpn[-1]][:2] if fpn else levels[-1]
    f += _lin(h * w, c, sh["MASK_DIM"])
    return f, sampling, levels, (h, w)


def _mha(q: int, k: int, c: int) -> float:
    return 2 * _lin(q, c, c) + 2 * _lin(k, c, c) + 4.0 * q * k * c


def mask2former(m: dict, sh: dict, levels, hm_wm, training: bool) -> float:
    c, q = m["HIDDEN_DIM"], m["NUM_OBJECT_QUERIES"]
    nc = sh["NUM_CLASSES"]
    nfl = sh["NUM_FEATURE_LEVELS"]
    hw_m = hm_wm[0] * hm_wm[1]
    md = sh["MASK_DIM"]
    head = _lin(q, c, nc + 1) + 2 * _lin(q, c, c) + _lin(q, c, md)
    mask = 2.0 * q * md * hw_m
    f = sum(_lin(h * w, sh["CONVS_DIM"], c) for h, w in levels[:nfl])
    f += head + (mask if training else 0.0)
    for li in range(m["DEC_LAYERS"] - 1):
        h, w = levels[li % nfl]
        if not training:
            f += 2.0 * q * md * h * w            # the gate at the level
        f += (_mha(q, h * w, c) + _mha(q, q, c)
              + 2 * _lin(q, c, m["DIM_FEEDFORWARD"]) + head
              + (mask if training else 0.0))
    return f + (0.0 if training else mask)


def maskdino(m: dict, sh: dict, levels, hm_wm, training: bool
             ) -> Tuple[float, float]:
    c, q = m["HIDDEN_DIM"], m["NUM_OBJECT_QUERIES"]
    nc, md = sh["NUM_CLASSES"], sh["MASK_DIM"]
    s = sum(h * w for h, w in levels)
    nl = len(levels)
    hw_m = hm_wm[0] * hm_wm[1]
    box = 2 * _lin(q, c, c) + _lin(q, c, 4)
    masks = 2 * _lin(q, c, c) + _lin(q, c, md) + 2.0 * q * md * hw_m
    f = (_lin(s, c, c) + _lin(s, c, nc) + 2 * _lin(s, c, c) + _lin(s, c, 4)
         + 2 * _lin(q, c, nc) + (2 * masks if training else 0.0))
    sampling = 0.0
    layers = m["DEC_LAYERS"] - 1
    for li in range(layers):
        prod, samp = _msda(q, s, c, m["NHEADS"], nl, sh["DEFORM_NUM_POINTS"])
        f += (_lin(q, 2 * c, c) + _lin(q, c, c) + _mha(q, q, c) + prod
              + 2 * _lin(q, c, m["DIM_FEEDFORWARD"]) + 2 * box
              + _lin(q, c, nc)
              + (masks if training or li == layers - 1 else 0.0))
        sampling += samp
    return f, sampling


def model_flops(cfg: dict, h: int, w: int, training: bool
                ) -> Dict[str, float]:
    """{"products", "sampling", "total"} FLOPs of one image at h x w."""
    mo = cfg["MODEL"]
    if mo["BACKBONE"]["NAME"] == "swin":
        fb, maps = swin(mo["SWIN"], h, w)
    else:
        fb, maps = resnet(mo["RESNETS"], h, w)
    sh = mo["SEM_SEG_HEAD"]
    fp, sp, levels, hm = pixel_decoder(sh, maps)
    if mo["MASK_DINO"]["ENABLED"] or mo["META_ARCHITECTURE"] == "MaskDINO":
        fd, sd = maskdino(mo["MASK_FORMER"], sh, levels, hm, training)
    else:
        fd, sd = mask2former(mo["MASK_FORMER"], sh, levels, hm,
                             training), 0.0
    prod, samp = fb + fp + fd, sp + sd
    if training:
        prod, samp = 3 * prod, samp * (10.0 + 16.0) / 10.0
    return {"products": prod, "sampling": samp, "total": prod + samp}

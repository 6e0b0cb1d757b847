"""Swin Transformer (plain window attention) and ResNet with FrozenBN, in
the detectron2 / timm detection fork's state-dict layout, NHWC out."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import (Conv2dNorm, DropPath,
                                        FrozenBatchNorm, LayerNorm, Mlp)


def relative_position_index(ws: int) -> torch.Tensor:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (ws - 1)
    return torch.from_numpy(rel[..., 0] * (2 * ws - 1) + rel[..., 1]).long()


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_unpartition(x: torch.Tensor, ws: int, h: int,
                       w: int) -> torch.Tensor:
    c = x.shape[-1]
    b = x.shape[0] // ((h // ws) * (w // ws))
    x = x.view(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def shift_mask(hp: int, wp: int, ws: int, shift: int,
               device) -> torch.Tensor:
    """(nW, N, N) additive mask of Swin's shifted windows: -100 between
    tokens of different regions of the rolled map."""
    img = torch.zeros(hp, wp, dtype=torch.long, device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    lab = window_partition(img[None, :, :, None], ws)[..., 0]   # (nW, N)
    keep = lab[:, :, None] == lab[:, None, :]
    return torch.where(keep, 0.0, -100.0)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 qkv_bias: bool = True, qk_scale: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window_size),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        nwt, n, _ = x.shape
        nh = self.num_heads
        q, k, v = self.qkv(x).view(nwt, n, 3, nh, -1).permute(2, 0, 3, 1, 4)
        idx = self.relative_position_index.reshape(-1)
        bias = self.relative_position_bias_table[idx].view(n, n, -1) \
            .permute(2, 0, 1)
        attn = (q * self.scale) @ k.transpose(-2, -1) + bias
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(nwt // nw, nw, nh, n, n)
                    + mask[None, :, None]).view(nwt, nh, n, n)
        out = attn.softmax(-1) @ v
        return self.proj(out.transpose(1, 2).reshape(nwt, n, -1))


class SwinBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift_size, mlp_ratio,
                 qkv_bias, qk_scale, drop_path):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size, qkv_bias,
                                    qk_scale)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim)

    def forward(self, x, generator=None):
        keep_attn = self.drop_path.draw(x, generator)
        keep_mlp = self.drop_path.draw(x, generator)
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x)
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = shift_mask(hp, wp, ws, shift, x.device)
        x = window_unpartition(self.attn(window_partition(x, ws), mask),
                               ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + self.drop_path(x[:, :h, :w], keep_attn)
        return x + self.drop_path(self.mlp(self.norm2(x)), keep_mlp)


def drop_path_draws(model: nn.Module, batch: int, generator) -> list:
    """Every Swin block's two keep masks for a whole batch, drawn from
    ``generator`` in the forward's order (for ``PresetDraws``)."""
    dev = next(model.parameters()).device
    masks = []
    for blk in model.modules():
        if isinstance(blk, SwinBlock):
            for _ in range(2):
                keep = blk.drop_path.draw(
                    torch.empty((batch, 1, 1, 1), device=dev), generator)
                if keep is not None:
                    masks.append(keep)
    return masks


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class _PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, patch_norm: bool):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim) if patch_norm else None


class _Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """(B, H, W, 3) normalized -> {res2..res5} NHWC (no APE)."""

    def __init__(self, embed_dim=96, depths=(2, 2, 6, 2),
                 num_heads=(3, 6, 12, 24), window_size=7, patch_size=4,
                 mlp_ratio=4.0, qkv_bias=True, qk_scale=0.0,
                 drop_path_rate=0.3, patch_norm=True,
                 out_features: Sequence[str] = ("res2", "res3", "res4",
                                                "res5")):
        super().__init__()
        self.patch_size = patch_size
        self.out_features = tuple(out_features)
        self.patch_embed = _PatchEmbed(patch_size, embed_dim, patch_norm)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        stages, blk = [], 0
        for s, depth in enumerate(depths):
            dim = embed_dim * 2 ** s
            blocks = [SwinBlock(dim, num_heads[s], window_size,
                                0 if d % 2 == 0 else window_size // 2,
                                mlp_ratio, qkv_bias, qk_scale, dpr[blk + d])
                      for d in range(depth)]
            blk += depth
            down = PatchMerging(dim) if s < len(depths) - 1 else None
            stages.append(_Stage(blocks, down))
            if f"res{s + 2}" in self.out_features:
                self.add_module(f"norm{s}", LayerNorm(dim))
        self.layers = nn.ModuleList(stages)

    def forward(self, x, generator=None) -> Dict[str, torch.Tensor]:
        ps = self.patch_size
        h0, w0 = x.shape[1:3]
        ph, pw = (ps - h0 % ps) % ps, (ps - w0 % ps) % ps
        if ph or pw:
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.patch_embed.norm is not None:
            x = self.patch_embed.norm(x)
        outs = {}
        for s, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x, generator)
            name = f"res{s + 2}"
            if name in self.out_features:
                outs[name] = getattr(self, f"norm{s}")(x)
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


class BottleneckBlock(nn.Module):
    def __init__(self, cin, cout, mid, stride=1):
        super().__init__()
        self.conv1 = Conv2dNorm(cin, mid, 1, FrozenBatchNorm(mid), stride)
        self.conv2 = Conv2dNorm(mid, mid, 3, FrozenBatchNorm(mid))
        self.conv3 = Conv2dNorm(mid, cout, 1, FrozenBatchNorm(cout))
        self.shortcut = None
        if cin != cout or stride != 1:
            self.shortcut = Conv2dNorm(cin, cout, 1, FrozenBatchNorm(cout),
                                       stride)

    def forward(self, x):
        out = F.relu(self.conv1.norm(self.conv1(x)))
        out = F.relu(self.conv2.norm(self.conv2(out)))
        out = self.conv3.norm(self.conv3(out))
        sc = x if self.shortcut is None else self.shortcut.norm(
            self.shortcut(x))
        return F.relu(out + sc)


_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class ResNet(nn.Module):
    """detectron2 ResNet, stride in the 1x1, FrozenBN; NHWC in and out."""

    def __init__(self, depth=50, stem_out_channels=64,
                 out_features=("res2", "res3", "res4", "res5")):
        super().__init__()
        self.out_features = tuple(out_features)
        self.stem = nn.Module()
        self.stem.conv1 = Conv2dNorm(3, stem_out_channels, 7,
                                     FrozenBatchNorm(stem_out_channels), 2)
        cin = stem_out_channels
        for stage, n in enumerate(_BLOCKS[depth]):
            cout, mid = 256 << stage, 64 << stage
            blocks = []
            for i in range(n):
                blocks.append(BottleneckBlock(
                    cin, cout, mid, 2 if i == 0 and stage > 0 else 1))
                cin = cout
            self.add_module(f"res{stage + 2}", nn.Sequential(*blocks))

    def forward(self, x, generator=None) -> Dict[str, torch.Tensor]:
        del generator
        conv = self.stem.conv1
        x = F.relu(conv.norm(conv(x.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = {}
        for stage in range(4):
            name = f"res{stage + 2}"
            x = getattr(self, name)(x)
            if name in self.out_features:
                outs[name] = x.permute(0, 2, 3, 1)
        return outs


RESNET_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


def build_backbone(m: dict) -> tuple:
    """(backbone, channels per output) from the configuration's MODEL."""
    if m["BACKBONE"]["NAME"] == "swin":
        s = m["SWIN"]
        if s.get("APE"):
            raise ValueError("the reference has no absolute position "
                             "embedding")
        net = SwinTransformer(
            embed_dim=s["EMBED_DIM"], depths=tuple(s["DEPTHS"]),
            num_heads=tuple(s["NUM_HEADS"]), window_size=s["WINDOW_SIZE"],
            patch_size=s["PATCH_SIZE"], mlp_ratio=s["MLP_RATIO"],
            qkv_bias=s["QKV_BIAS"], qk_scale=s["QK_SCALE"],
            drop_path_rate=s["DROP_PATH_RATE"], patch_norm=s["PATCH_NORM"],
            out_features=tuple(s["OUT_FEATURES"]))
        return net, {f"res{i + 2}": s["EMBED_DIM"] * 2 ** i
                     for i in range(4)}
    r = m["RESNETS"]
    return (ResNet(r["DEPTH"], r["STEM_OUT_CHANNELS"],
                   tuple(r["OUT_FEATURES"])), dict(RESNET_CHANNELS))

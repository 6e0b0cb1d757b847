"""Traditional augmentation (host side), the port's copy of
``vision_instance_seg_tpu/data/augment.py`` without cv2.

The reference's Albumentations 2.x pipeline
(scripts/augmentation/traditional_augment.py:47-64): the same ops,
probabilities and parameter ranges, applied jointly to an image and its N
instance masks (geometric ops take nearest-neighbour for the masks), with
the same draws from the caller's ``np.random.Generator`` in the same order,
so a call leaves the generator where the JAX package's call leaves it and
returns the same bytes.

Ops (probability, params):
  HorizontalFlip .5 | VerticalFlip .3 | Rotate +-15 .5 |
  ShiftScaleRotate (shift .0625, scale .1, rot 15) .5 |
  RandomBrightnessContrast (.2, .2) .5 | HueSaturationValue (20,30,20) .3 |
  GaussNoise std 0.02-0.10 .3 | GaussianBlur k 3-5 .3

cv2's calls (``warpAffine``, ``cvtColor`` RGB <-> HSV, ``GaussianBlur``)
run in ``native/augment.c``, built by gcc at first use, which computes
what OpenCV 5.0.0 computes byte for byte; ``getRotationMatrix2D`` is its
float64 formula here. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Sequence, Tuple

import numpy as np

from vision_instance_seg_tpu_torch.data.native.build import build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.c_int32


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build("augment")))
    for name in ("aug_warp_linear_c3", "aug_warp_nearest_c1"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_U8P, _I32, _I32, _F32P, _U8P, _I32, _I32]
    lib.aug_rgb2hsv.restype = ctypes.c_int
    lib.aug_rgb2hsv.argtypes = [_U8P, ctypes.c_int64, _U8P]
    lib.aug_hsv2rgb.restype = ctypes.c_int
    lib.aug_hsv2rgb.argtypes = [_U8P, _I32, _I32, _U8P]
    lib.aug_gaussian_blur.restype = ctypes.c_int
    lib.aug_gaussian_blur.argtypes = [_U8P, _I32, _I32, _I32, _I32, _U8P]
    return lib


def _check(r: int, what: str) -> None:
    if r:
        raise (MemoryError if r == -1 else ValueError)(f"{what} failed ({r})")


def _u8(img: np.ndarray, ndim: int, what: str) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != ndim or (ndim == 3 and img.shape[2] != 3):
        shape = "(H, W, 3)" if ndim == 3 else "(H, W)"
        raise ValueError(f"{what} takes a {shape} uint8 image, got {img.shape} {img.dtype}")
    return np.ascontiguousarray(img)


def rotation_matrix(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the centre rounded
    to float32 (cv2 takes a Point2f), the rest in float64."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _inverse_f32(mat: np.ndarray) -> np.ndarray:
    """warpAffine's inverse of a forward 2 x 3 map, in float64 as cv2
    inverts it, rounded to float32."""
    m = np.asarray(mat, np.float64).reshape(6)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[4] * d, m[0] * d, m[1] * -d, m[3] * -d
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.ascontiguousarray([a11, a12, b1, a21, a22, b2], np.float32)


def warp_affine_linear(img: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """``cv2.warpAffine(img, mat, (w, h), INTER_LINEAR, BORDER_CONSTANT, 0)``
    for an (H, W, 3) uint8 image."""
    img = _u8(img, 3, "warp_affine_linear")
    h, w = img.shape[:2]
    out = np.empty_like(img)
    inv = _inverse_f32(mat)
    _check(_lib().aug_warp_linear_c3(img.ctypes.data_as(_U8P), h, w, inv.ctypes.data_as(_F32P),
                                     out.ctypes.data_as(_U8P), h, w), "warp_affine_linear")
    return out


def warp_affine_nearest(mask: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """``cv2.warpAffine(mask, mat, (w, h), INTER_NEAREST, BORDER_CONSTANT,
    0)`` for an (H, W) uint8 mask."""
    mask = _u8(mask, 2, "warp_affine_nearest")
    h, w = mask.shape
    out = np.empty_like(mask)
    inv = _inverse_f32(mat)
    _check(_lib().aug_warp_nearest_c1(mask.ctypes.data_as(_U8P), h, w, inv.ctypes.data_as(_F32P),
                                      out.ctypes.data_as(_U8P), h, w), "warp_affine_nearest")
    return out


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` on uint8: hue 0..179."""
    img = _u8(img, 3, "rgb_to_hsv")
    out = np.empty_like(img)
    _check(_lib().aug_rgb2hsv(img.ctypes.data_as(_U8P), img.shape[0] * img.shape[1],
                              out.ctypes.data_as(_U8P)), "rgb_to_hsv")
    return out


def hsv_to_rgb(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_HSV2RGB)`` on uint8."""
    img = _u8(img, 3, "hsv_to_rgb")
    out = np.empty_like(img)
    _check(_lib().aug_hsv2rgb(img.ctypes.data_as(_U8P), img.shape[0], img.shape[1],
                              out.ctypes.data_as(_U8P)), "hsv_to_rgb")
    return out


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` on an (H, W) or (H, W, C)
    uint8 image, k 3 or 5."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"gaussian_blur takes a uint8 image, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    out = np.empty_like(img)
    _check(_lib().aug_gaussian_blur(img.ctypes.data_as(_U8P), h, w, c, int(k),
                                    out.ctypes.data_as(_U8P)), "gaussian_blur")
    return out


def _affine(img: np.ndarray, masks: List[np.ndarray], mat: np.ndarray
            ) -> Tuple[np.ndarray, List[np.ndarray]]:
    return warp_affine_linear(img, mat), [warp_affine_nearest(m, mat) for m in masks]


class TraditionalAugmenter:
    """Joint image+masks augmentation, seeded via numpy Generator."""

    def __init__(self,
                 p_hflip: float = 0.5, p_vflip: float = 0.3,
                 p_rotate: float = 0.5, rotate_limit: float = 15.0,
                 p_ssr: float = 0.5, shift_limit: float = 0.0625,
                 scale_limit: float = 0.1, ssr_rotate_limit: float = 15.0,
                 p_bc: float = 0.5, brightness_limit: float = 0.2,
                 contrast_limit: float = 0.2,
                 p_hsv: float = 0.3, hue_shift: float = 20.0,
                 sat_shift: float = 30.0, val_shift: float = 20.0,
                 p_noise: float = 0.3,
                 noise_std: Tuple[float, float] = (0.02, 0.10),
                 p_blur: float = 0.3, blur_limit: Tuple[int, int] = (3, 5)):
        self.p = dict(hflip=p_hflip, vflip=p_vflip, rotate=p_rotate,
                      ssr=p_ssr, bc=p_bc, hsv=p_hsv, noise=p_noise,
                      blur=p_blur)
        self.rotate_limit = rotate_limit
        self.shift_limit = shift_limit
        self.scale_limit = scale_limit
        self.ssr_rotate_limit = ssr_rotate_limit
        self.brightness_limit = brightness_limit
        self.contrast_limit = contrast_limit
        self.hue_shift = hue_shift
        self.sat_shift = sat_shift
        self.val_shift = val_shift
        self.noise_std = noise_std
        self.blur_limit = blur_limit

    def __call__(self, image: np.ndarray, masks: Sequence[np.ndarray],
                 rng: np.random.Generator
                 ) -> Tuple[np.ndarray, List[np.ndarray]]:
        img = image.copy()
        msks = [np.ascontiguousarray(m, dtype=np.uint8) for m in masks]
        h, w = img.shape[:2]

        # ---------------- geometric (joint)
        if rng.random() < self.p["hflip"]:
            img = img[:, ::-1].copy()
            msks = [m[:, ::-1].copy() for m in msks]
        if rng.random() < self.p["vflip"]:
            img = img[::-1].copy()
            msks = [m[::-1].copy() for m in msks]
        if rng.random() < self.p["rotate"]:
            ang = rng.uniform(-self.rotate_limit, self.rotate_limit)
            mat = rotation_matrix((w / 2, h / 2), ang, 1.0)
            img, msks = _affine(img, msks, mat)
        if rng.random() < self.p["ssr"]:
            ang = rng.uniform(-self.ssr_rotate_limit, self.ssr_rotate_limit)
            scale = 1.0 + rng.uniform(-self.scale_limit, self.scale_limit)
            dx = rng.uniform(-self.shift_limit, self.shift_limit) * w
            dy = rng.uniform(-self.shift_limit, self.shift_limit) * h
            mat = rotation_matrix((w / 2, h / 2), ang, scale)
            mat[0, 2] += dx
            mat[1, 2] += dy
            img, msks = _affine(img, msks, mat)

        # ---------------- photometric (image only)
        if rng.random() < self.p["bc"]:
            alpha = 1.0 + rng.uniform(-self.contrast_limit, self.contrast_limit)
            beta = rng.uniform(-self.brightness_limit,
                               self.brightness_limit) * 255.0
            img = np.clip(img.astype(np.float32) * alpha + beta,
                          0, 255).astype(np.uint8)
        if rng.random() < self.p["hsv"]:
            hsv = rgb_to_hsv(img).astype(np.int32)
            hsv[..., 0] = (hsv[..., 0]
                           + int(rng.uniform(-self.hue_shift, self.hue_shift))
                           ) % 180
            hsv[..., 1] = np.clip(
                hsv[..., 1] + int(rng.uniform(-self.sat_shift, self.sat_shift)),
                0, 255)
            hsv[..., 2] = np.clip(
                hsv[..., 2] + int(rng.uniform(-self.val_shift, self.val_shift)),
                0, 255)
            img = hsv_to_rgb(hsv.astype(np.uint8))
        if rng.random() < self.p["noise"]:
            std = rng.uniform(*self.noise_std) * 255.0
            noise = rng.normal(0.0, std, img.shape).astype(np.float32)
            img = np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)
        if rng.random() < self.p["blur"]:
            k = int(rng.integers(self.blur_limit[0] // 2,
                                 self.blur_limit[1] // 2 + 1)) * 2 + 1
            img = gaussian_blur(img, k)
        return img, msks

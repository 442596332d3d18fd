"""Host-side image decode and augmentation: the reference's tf.image
stage of the ImageNet input pipeline (a copy of the JAX package's
``data/image.py`` on its PIL path, numpy and PIL only).

Training records are decoded, cut with an Inception-style random resized
crop and flipped at random; evaluation records are resized on their short
side and cut at the centre.  The functions are registered in
``filesource.TRANSFORMS`` under ``imagenet_(train|eval)[_u8]_{SIZE}``
(any size, on demand: ``ensure_registered``), so they run wherever
records are read: the in-process loader or the data service's workers,
where the name travels inside the picklable ``SourceSpec``.  The ``_u8``
transforms ship the raw uint8 crop, a quarter of the bytes; the ResNet
task normalises uint8 batches on the device.

Determinism: the augmentation draws from ``SeedSequence([crc32(encoded
bytes), epoch])``, so a record augments alike on every worker and after
a restart within an epoch, and differently in the next epoch.  The
epoch reaches the transform through ``pipeline.fetch_record``
(``filesource.transform_is_epoch_aware``).

Record schema: ``image/encoded`` (JPEG bytes) and ``image/class/label``,
as the reference's ImageNet TFRecords carry them, or bare ``jpeg`` and
``label``.

PIL is imported inside the calls, so the package imports without it.
The JAX package's native libjpeg decoder is not ported: every image
decodes through PIL.
"""

from __future__ import annotations

import io
import re
import zlib
from functools import partial

import numpy as np

# ImageNet channel statistics (the torchvision/MLPerf convention).
MEAN_RGB = np.asarray([0.485, 0.456, 0.406], np.float32)
STDDEV_RGB = np.asarray([0.229, 0.224, 0.225], np.float32)

# Not "image": elsewhere that key holds DECODED pixels.
_ENCODED_KEYS = ("image/encoded", "jpeg")
_LABEL_KEYS = ("image/class/label", "label")


def _encoded_bytes(rec: dict) -> bytes:
    for k in _ENCODED_KEYS:
        v = rec.get(k)
        if v is None:
            continue
        if isinstance(v, (list, tuple)):  # raw TFRecord bytes_list
            v = v[0]
        if isinstance(v, np.ndarray):
            v = v.tobytes()
        if isinstance(v, (bytes, bytearray)):
            return bytes(v)
    raise KeyError(
        f"record has no encoded image under any of {_ENCODED_KEYS} "
        f"(keys: {sorted(rec)})")


def _label(rec: dict) -> np.int32:
    for k in _LABEL_KEYS:
        v = rec.get(k)
        if v is not None:
            return np.int32(np.asarray(v).ravel()[0])
    raise KeyError(
        f"record has no label under any of {_LABEL_KEYS} "
        f"(keys: {sorted(rec)})")


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "Pillow is required for JPEG decode and ImageNet augmentation "
            "(the imagenet_* transforms)") from e
    return Image


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes (JPEG, PNG, ...) → uint8 [H, W, 3] RGB."""
    Image = _pil_image()
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _normalize(img_u8: np.ndarray) -> np.ndarray:
    return ((img_u8.astype(np.float32) / 255.0) - MEAN_RGB) / STDDEV_RGB


def random_resized_crop(img: np.ndarray, size: int,
                        rng: np.random.Generator,
                        *, area_range=(0.08, 1.0),
                        ratio_range=(3 / 4, 4 / 3),
                        attempts: int = 10) -> np.ndarray:
    """Inception-style crop: sample area and aspect, fall back to the
    centre crop after ``attempts`` misses."""
    Image = _pil_image()
    h, w = img.shape[:2]
    area = h * w
    for _ in range(attempts):
        target = area * rng.uniform(*area_range)
        log_ratio = np.log(ratio_range)
        ratio = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target * ratio)))
        ch = int(round(np.sqrt(target / ratio)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            crop = img[top:top + ch, left:left + cw]
            return np.asarray(
                Image.fromarray(crop).resize((size, size), Image.BILINEAR),
                np.uint8)
    return center_crop(img, size)


def center_crop(img: np.ndarray, size: int,
                *, crop_padding: int = 32) -> np.ndarray:
    """Resize the short side to ``size + crop_padding``, then cut the
    central ``size`` square (the evaluation convention)."""
    Image = _pil_image()
    h, w = img.shape[:2]
    scale = (size + crop_padding) / min(h, w)
    nh = max(size, int(round(h * scale)))
    nw = max(size, int(round(w * scale)))
    resized = np.asarray(
        Image.fromarray(img).resize((nw, nh), Image.BILINEAR), np.uint8)
    top = (nh - size) // 2
    left = (nw - size) // 2
    return resized[top:top + size, left:left + size]


def _train_crop_u8(data: bytes, size: int, epoch: int) -> np.ndarray:
    """Encoded bytes → the augmented uint8 crop of this epoch."""
    rng = np.random.default_rng(
        np.random.SeedSequence([zlib.crc32(data), int(epoch)]))
    img = random_resized_crop(decode_image(data), size, rng)
    if rng.random() < 0.5:
        img = img[:, ::-1]
    return img


def imagenet_train_record(rec: dict, *, size: int = 224,
                          epoch: int = 0) -> dict:
    """Training record: decode, crop, flip, normalise (f32)."""
    data = _encoded_bytes(rec)
    return {"image": np.ascontiguousarray(
                _normalize(_train_crop_u8(data, size, epoch))),
            "label": _label(rec)}


def imagenet_train_record_u8(rec: dict, *, size: int = 224,
                             epoch: int = 0) -> dict:
    """``imagenet_train_record`` without the normalisation: raw uint8
    pixels, normalised on the device."""
    data = _encoded_bytes(rec)
    return {"image": np.ascontiguousarray(_train_crop_u8(data, size, epoch)),
            "label": _label(rec)}


def imagenet_eval_record(rec: dict, *, size: int = 224) -> dict:
    """Evaluation record: decode, centre crop, normalise (f32)."""
    img = center_crop(decode_image(_encoded_bytes(rec)), size)
    return {"image": _normalize(img), "label": _label(rec)}


def imagenet_eval_record_u8(rec: dict, *, size: int = 224) -> dict:
    """``imagenet_eval_record`` in raw uint8 pixels."""
    img = center_crop(decode_image(_encoded_bytes(rec)), size)
    return {"image": np.ascontiguousarray(img), "label": _label(rec)}


_NAME_RE = re.compile(r"imagenet_(train|eval)(_u8)?_(\d+)$")


def ensure_registered(name: str) -> None:
    """Register ``imagenet_(train|eval)[_u8]_{SIZE}`` for any size; other
    names are left alone."""
    m = _NAME_RE.fullmatch(name)
    if m is None:
        return
    from tensorflow_train_distributed_torch.data.filesource import TRANSFORMS

    if m.group(2):
        fn = (imagenet_train_record_u8 if m.group(1) == "train"
              else imagenet_eval_record_u8)
    else:
        fn = (imagenet_train_record if m.group(1) == "train"
              else imagenet_eval_record)
    TRANSFORMS.setdefault(name, partial(fn, size=int(m.group(3))))


def register_transforms() -> None:
    """Pre-install the common names (other sizes resolve on demand)."""
    for size in (224, 32):
        ensure_registered(f"imagenet_train_{size}")
        ensure_registered(f"imagenet_eval_{size}")


register_transforms()

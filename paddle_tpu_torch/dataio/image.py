"""Image preprocessing utilities.

The port of ``paddle_tpu/dataio/image.py``: host code on numpy, the same
samples, ids and errors for the same inputs and seeds.

Parity: python/paddle/dataset/image.py (resize_short, to_chw,
center_crop, random_crop, left_right_flip, simple_transform,
load_and_transform, load_image, load_image_bytes,
batch_images_from_tar).

The reference shells out to cv2 for everything; here the
per-image work is numpy (the heavy path belongs in the native pipeline
— data_pipeline.cc — or on-device via ops.nn.interpolate). Geometry ops
here are pure numpy so they run everywhere; JPEG/PNG *decoding* needs
cv2 or PIL and raises a clear error when neither is present.

Images are HWC uint8/float arrays like the reference's cv2 convention.
"""

import os
import pickle
import tarfile

import numpy as np

__all__ = [
    "batch_images_from_tar", "load_image_bytes", "load_image",
    "resize_short", "to_chw", "center_crop", "random_crop",
    "left_right_flip", "simple_transform", "load_and_transform",
]


def _decode(data, is_color=True):
    try:
        import cv2
        flag = cv2.IMREAD_COLOR if is_color else cv2.IMREAD_GRAYSCALE
        img = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        if img is None:
            raise ValueError("cv2 could not decode image bytes")
        return img
    except ImportError:
        pass
    try:
        import io as _io
        from PIL import Image
        img = Image.open(_io.BytesIO(data))
        img = img.convert("RGB" if is_color else "L")
        return np.asarray(img)
    except ImportError:
        raise RuntimeError(
            "decoding images needs cv2 or PIL; neither is installed "
            "(geometry-only helpers — resize/crop/flip — work without)")


def load_image_bytes(data, is_color=True):
    """Decode an encoded image from a bytes object."""
    return _decode(data, is_color)


def load_image(file, is_color=True):
    """Decode an encoded image file."""
    with open(file, "rb") as f:
        return _decode(f.read(), is_color)


def _resize_bilinear_np(img, oh, ow):
    """Pure-numpy bilinear resize over HWC (half-pixel centers)."""
    img = np.asarray(img)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, c = img.shape
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    f = img.astype(np.float32)
    top = f[y0][:, x0] * (1 - wx) + f[y0][:, x1] * wx
    bot = f[y1][:, x0] * (1 - wx) + f[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    else:
        out = out.astype(img.dtype)
    return out[:, :, 0] if squeeze else out


def resize_short(im, size):
    """Resize so the SHORT edge becomes ``size``, keeping aspect."""
    h, w = im.shape[:2]
    short = min(h, w)
    oh = int(round(h * size / short))
    ow = int(round(w * size / short))
    return _resize_bilinear_np(im, oh, ow)


def to_chw(im, order=(2, 0, 1)):
    """HWC -> CHW (the training layout; ref image.py to_chw)."""
    return np.asarray(im).transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    hs = max((h - size) // 2, 0)
    ws = max((w - size) // 2, 0)
    return im[hs:hs + size, ws:ws + size]


def random_crop(im, size, is_color=True, rng=None):
    rng = rng or np.random
    h, w = im.shape[:2]
    hs = rng.randint(0, max(h - size, 0) + 1)
    ws = rng.randint(0, max(w - size, 0) + 1)
    return im[hs:hs + size, ws:ws + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None, rng=None):
    """resize_short -> crop(+flip when training) -> CHW -> mean-subtract
    (ref image.py simple_transform)."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        if (rng or np.random).randint(2) == 0:
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1 and im.ndim == 3:
            mean = mean[:, None, None]
        im = im - mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pack a tar of images into pickled batch files (ref image.py
    batch_images_from_tar: {'data': [bytes...], 'label': [...]} per
    batch, plus a batch-name manifest). Stores ENCODED bytes like the
    reference — decoding stays in the consumer."""
    out_path = f"{data_file}_{dataset_name}_batch"
    os.makedirs(out_path, exist_ok=True)
    data, labels, file_id, names = [], [], 0, []
    with tarfile.open(data_file) as tf:
        for mem in tf.getmembers():
            if mem.name not in img2label:
                continue
            data.append(tf.extractfile(mem).read())
            labels.append(img2label[mem.name])
            if len(data) == num_per_batch:
                name = os.path.join(out_path, f"batch_{file_id}")
                with open(name, "wb") as f:
                    pickle.dump({"data": data, "label": labels}, f,
                                protocol=2)
                names.append(name)
                file_id += 1
                data, labels = [], []
    if data:
        name = os.path.join(out_path, f"batch_{file_id}")
        with open(name, "wb") as f:
            pickle.dump({"data": data, "label": labels}, f, protocol=2)
        names.append(name)
    with open(os.path.join(out_path, "batch_names.txt"), "w") as f:
        f.write("\n".join(names))
    return out_path

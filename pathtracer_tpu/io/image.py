"""Host image I/O (the reference's stb/CImg/hdr stack, utils.h:17-18,
hdrwriter.h:5).

PNG and Radiance .hdr are written with numpy + zlib; other formats (JPEG
output, texture images to read) go through Pillow, imported only when
such a file is touched."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:          # pragma: no cover - depends on host
        raise ImportError(
            'reading images and writing formats other than PNG/HDR needs '
            'Pillow (pip install pillow)') from e
    return Image


def encode_png(u8_image: np.ndarray) -> bytes:
    """(H,W,3) or (H,W) uint8 -> PNG bytes (8-bit RGB/gray, no filter)."""
    img = np.ascontiguousarray(np.asarray(u8_image, np.uint8))
    if img.ndim == 2:
        color_type, ch = 0, 1
    else:
        color_type, ch = {1: (0, 1), 3: (2, 3), 4: (6, 4)}[img.shape[2]]
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + w * ch), np.uint8)     # filter byte 0 per row
    raw[:, 1:] = img.reshape(h, w * ch)

    def chunk(tag, data):
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))

    ihdr = struct.pack('>IIBBBBB', w, h, 8, color_type, 0, 0, 0)
    return (b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', ihdr)
            + chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
            + chunk(b'IEND', b''))


def save_image(path: str, u8_image: np.ndarray):
    """Save (H,W,3) uint8 (reference save_image, utils.cpp:178)."""
    if str(path).lower().endswith('.png'):
        with open(path, 'wb') as f:
            f.write(encode_png(u8_image))
        return
    _pil_image().fromarray(np.asarray(u8_image)).save(path)


def load_image(path: str) -> np.ndarray:
    """Load as (H,W,3) float32 in [0,255] raw values (reference load_image)."""
    return np.asarray(_pil_image().open(path).convert('RGB'), np.float32)


def save_hdr(path: str, image: np.ndarray):
    """Radiance .hdr writer (reference EncodeRadianceHDR, hdrwriter.h:5):
    RGBE encoding + adaptive RLE scanlines (the 0x02 0x02 format every
    loader, including ours, understands)."""
    img = np.asarray(image, np.float32)
    h, w, _ = img.shape

    # RGBE encode (vectorized): e = exponent of max channel, mantissas
    # scaled to [0, 256)
    m = img.max(axis=-1)
    valid = m >= 1e-32
    with np.errstate(divide='ignore', invalid='ignore'):
        frac, exp = np.frexp(m)
        scale = np.where(valid, frac * 256.0 / np.maximum(m, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, exp + 128, 0).astype(np.uint8)

    out = bytearray()
    out += b'#?RADIANCE\n# written by pathtracer_tpu\nFORMAT=32-bit_rle_rgbe\n\n'
    out += f'-Y {h} +X {w}\n'.encode()
    for y in range(h):
        out += bytes((2, 2, (w >> 8) & 0xFF, w & 0xFF))
        for c in range(4):
            row = rgbe[y, :, c]
            x = 0
            while x < w:
                # find run length at x
                run_end = x + 1
                while (run_end < w and run_end - x < 127
                       and row[run_end] == row[x]):
                    run_end += 1
                if run_end - x >= 4:          # worthwhile run
                    out += bytes((128 + (run_end - x), int(row[x])))
                    x = run_end
                else:
                    # literal: scan ahead until a >=4 run starts
                    lit_end = x
                    while lit_end < w and lit_end - x < 128:
                        r2 = lit_end + 1
                        while (r2 < w and r2 - lit_end < 4
                               and row[r2] == row[lit_end]):
                            r2 += 1
                        if r2 - lit_end >= 4:
                            break
                        lit_end = r2
                    lit_end = min(lit_end, x + 128, w)
                    if lit_end == x:
                        lit_end = x + 1
                    out += bytes((lit_end - x,)) + row[x:lit_end].tobytes()
                    x = lit_end
    with open(path, 'wb') as f:
        f.write(bytes(out))


def load_hdr(path: str) -> np.ndarray:
    """Radiance .hdr loader (reference hdrloader.h:19) -> (H,W,3) float32.

    Minimal RLE-capable parser; PIL lacks native HDR support.
    """
    with open(path, 'rb') as f:
        data = f.read()
    # header
    if not (data.startswith(b'#?RADIANCE') or data.startswith(b'#?RGBE')):
        raise ValueError('not a Radiance HDR file')
    pos = data.find(b'\n\n')
    header_end = pos + 2
    dims = data[header_end:data.find(b'\n', header_end)].split()
    # "-Y H +X W"
    h = int(dims[1])
    w = int(dims[3])
    pos = data.find(b'\n', header_end) + 1

    rgbe = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if (pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2
                and ((data[pos + 2] << 8) | data[pos + 3]) == w):
            # adaptive RLE scanline
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:  # run
                        rgbe[y, x:x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:            # literal
                        rgbe[y, x:x + count, c] = np.frombuffer(
                            data, np.uint8, count, pos)
                        pos += count
                        x += count
        else:
            # flat scanline
            row = np.frombuffer(data, np.uint8, w * 4, pos).reshape(w, 4)
            rgbe[y] = row
            pos += w * 4

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp > 0, np.ldexp(1.0, exp - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]

"""Minimal PNG codec (pure Python + stdlib zlib, numpy in/out).

The port's own copy of the JAX package's ``assets/png.py`` (``decode_png``,
``read_png``, ``encode_png``, ``write_png``), byte for byte in behaviour, so
both packages decode a texture to the same RGBA8 texels. It fills the role
of the engine's image importer / stb_image for PNG textures (the reference
feeds ``data/cube.png`` through ``ImageImporter::importImage``,
``src/mgr.cpp:318``).

Decoder support: 8-bit and 16-bit gray / gray+alpha / RGB / RGBA / palette,
all 5 scanline filters, plus Adam7 interlacing (7-pass deinterlace).
Output is always RGBA8 [H, W, 4] — the bake target.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"

# Channels per pixel for each PNG color type.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse PNG scanline filtering. raw: [height * (1 + stride)] u8."""
    out = np.zeros((height, stride), np.uint8)
    pos = 0
    prev = np.zeros((stride,), np.uint8)
    for y in range(height):
        ftype = int(raw[pos])
        pos += 1
        line = raw[pos : pos + stride].astype(np.int32)
        pos += stride
        if ftype == 0:  # None
            cur = line
        elif ftype == 1:  # Sub
            cur = line.copy()
            for x in range(bpp, stride):
                cur[x] = (cur[x] + cur[x - bpp]) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # Average
            cur = line.copy()
            p = prev.astype(np.int32)
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((left + p[x]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            cur = line.copy()
            p = prev.astype(np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = p[x]
                c = p[x - bpp] if x >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: bad filter type {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = out[y]
    return out


# Adam7 pass grid: (x_start, y_start, x_step, y_step) per pass.
_ADAM7 = [
    (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
    (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2),
]


def _deinterlace_adam7(raw: np.ndarray, width: int, height: int, bpp: int) -> np.ndarray:
    """Adam7: seven independently-filtered sub-images, merged on the pass
    grid. Returns flat bytes [height * width * bpp] like _unfilter."""
    full = np.zeros((height, width, bpp), np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw = (width - x0 + dx - 1) // dx
        ph = (height - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        size = ph * (pw * bpp + 1)
        if pos + size > raw.size:
            raise ValueError("PNG: interlaced IDAT stream truncated")
        sub = _unfilter(raw[pos : pos + size], ph, pw * bpp, bpp)
        pos += size
        full[y0::dy, x0::dx] = sub.reshape(ph, pw, bpp)
    if pos != raw.size:
        raise ValueError("PNG: interlaced IDAT stream has trailing data")
    return full.reshape(-1)


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes → RGBA8 numpy array [H, W, 4]."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    width = height = 0
    bit_depth = color_type = interlace = 0
    idat = bytearray()
    palette = None
    trns = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR" and width == 0:
            # Only the first IHDR counts (duplicate-IHDR guard, matching the
            # native decoder — a later IHDR must not redefine dimensions).
            width, height, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", body
            )
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif ctype == b"IDAT":
            idat.extend(body)
        elif ctype == b"IEND":
            break
    if bit_depth not in (8, 16):
        raise NotImplementedError(f"PNG: bit depth {bit_depth} not supported")
    if not (0 < width <= 1 << 20 and 0 < height <= 1 << 20
            and width * height <= 1 << 26):
        # Hostile-dimension bound (tier parity with the native decoder):
        # every buffer below is sized from the DECLARED header dims.
        raise ValueError(
            f"PNG dimensions {width}x{height} exceed the hostile-input bound"
        )
    channels = _CHANNELS[color_type]
    bytes_per_sample = bit_depth // 8
    bpp = channels * bytes_per_sample
    stride = width * bpp
    # Bounded inflate: a zlib bomb in IDAT must not materialize more than
    # the declared image can hold (interlaced raw <= w*h*bpp + one filter
    # byte per pass row, and pass rows sum to < 3*height + 7).
    cap = width * height * bpp + 3 * height + 64
    dec = zlib.decompressobj()
    raw_b = dec.decompress(bytes(idat), cap + 1)
    if len(raw_b) > cap:
        raise ValueError("PNG: IDAT inflates beyond the declared dimensions")
    raw = np.frombuffer(raw_b, np.uint8)
    if interlace:
        img = _deinterlace_adam7(raw, width, height, bpp)
    else:
        if raw.size != height * (stride + 1):
            raise ValueError(
                f"PNG: IDAT stream inflates to {raw.size} bytes, header "
                f"implies {height * (stride + 1)}"
            )
        img = _unfilter(raw, height, stride, bpp)
    if bit_depth == 16:
        # Keep the high byte (same as stb's 16→8 reduction).
        img = img.reshape(height, width, channels, 2)[..., 0]
    else:
        img = img.reshape(height, width, channels)

    out = np.zeros((height, width, 4), np.uint8)
    out[..., 3] = 255
    if color_type == 0:  # gray
        out[..., 0] = out[..., 1] = out[..., 2] = img[..., 0]
    elif color_type == 2:  # RGB
        out[..., :3] = img
    elif color_type == 3:  # palette
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        idx = img[..., 0]
        out[..., :3] = palette[idx]
        if trns is not None:
            alpha = np.full((len(palette),), 255, np.uint8)
            n = min(len(trns), len(palette))
            alpha[:n] = trns[:n]
            out[..., 3] = alpha[idx]
    elif color_type == 4:  # gray + alpha
        out[..., 0] = out[..., 1] = out[..., 2] = img[..., 0]
        out[..., 3] = img[..., 1]
    elif color_type == 6:  # RGBA
        out[...] = img
    else:
        raise ValueError(f"PNG: bad color type {color_type}")
    return out


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def encode_png(image: np.ndarray, interlace: bool = False) -> bytes:
    """Encode an RGBA8 / RGB8 / gray8 numpy image [H, W, C] or [H, W] to
    PNG (filter 0 scanlines; optionally Adam7-interlaced)."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype != np.uint8:
        raise ValueError("encode_png expects uint8")
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    if interlace:
        parts = []
        for x0, y0, dx, dy in _ADAM7:
            sub = img[y0::dy, x0::dx]
            ph, pw = sub.shape[:2]
            if ph == 0 or pw == 0:
                continue
            raw = np.zeros((ph, 1 + pw * c), np.uint8)
            raw[:, 1:] = sub.reshape(ph, pw * c)
            parts.append(raw.tobytes())
        compressed = zlib.compress(b"".join(parts), 6)
    else:
        # Filter type 0 on every scanline.
        raw = np.zeros((h, 1 + w * c), np.uint8)
        raw[:, 1:] = img.reshape(h, w * c)
        compressed = zlib.compress(raw.tobytes(), 6)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (
            struct.pack(">I", len(body))
            + ctype
            + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 1 if interlace else 0)
    return (
        _PNG_SIG
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", compressed)
        + chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))

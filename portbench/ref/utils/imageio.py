"""Host-side image IO: a stdlib PNG reader/writer and a minimal EXR reader.

Counterpart of the JAX package's utils/imageio.py. PNG decoding and
encoding are written here on `zlib` and `struct` alone, so the port needs no
imaging package: 8-bit RGB and RGBA, non-interlaced, scanline filters 0-4
(PNG specification §9). That covers the repo's textures
(scenes/box-texture.png is 128×128 8-bit RGB). The EXR reader is copied as
it is.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {2: 3, 6: 4}  # colour type → samples per pixel (RGB, RGBA)


def read_image(path) -> np.ndarray:
    """→ (H, W, 3) f32 linear-file values (no gamma applied here; the
    texture map applies inverse gamma for spectrum textures, matching
    the reference's scene/texture_map.rs:42-46)."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".png":
        return read_png(path)[..., :3].astype(np.float32) / 255.0
    if ext == ".exr":
        return read_exr(path)
    raise ValueError(f"unsupported image extension {ext!r} (png or exr)")


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters → (height, stride) uint8."""
    out = bytearray(height * stride)
    prev = bytearray(stride)
    pos = 0
    for y in range(height):
        ftype = raw[pos]
        line = bytearray(raw[pos + 1 : pos + 1 + stride])
        pos += 1 + stride
        if ftype == 1:  # Sub
            for i in range(bpp, stride):
                line[i] = (line[i] + line[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            for i in range(stride):
                line[i] = (line[i] + prev[i]) & 0xFF
        elif ftype == 3:  # Average
            for i in range(stride):
                left = line[i - bpp] if i >= bpp else 0
                line[i] = (line[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (line[i] + pred) & 0xFF
        elif ftype != 0:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y * stride : (y + 1) * stride] = line
        prev = line
    return np.frombuffer(bytes(out), np.uint8).reshape(height, stride)


def read_png(path) -> np.ndarray:
    """8-bit RGB/RGBA non-interlaced PNG → (H, W, 3|4) uint8."""
    buf = Path(path).read_bytes()
    if buf[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    off, header, idat = 8, None, []
    while off < len(buf):
        (n,) = struct.unpack(">I", buf[off : off + 4])
        ctype = buf[off + 4 : off + 8]
        data = buf[off + 8 : off + 8 + n]
        off += 12 + n
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"IDAT":
            idat.append(data)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _comp, _filt, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {color}, "
            f"interlace {interlace}); 8-bit RGB/RGBA non-interlaced only"
        )
    ch = _PNG_CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    return _unfilter(raw, height, width * ch, ch).reshape(height, width, ch)


def _png_chunk(ctype: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(ctype + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + ctype + data + struct.pack(">I", crc)


def write_png(path, rgb_u8: np.ndarray) -> None:
    """rgb_u8: (H, W, 3) uint8 → 8-bit RGB PNG (filter 0 on every row)."""
    img = np.ascontiguousarray(np.asarray(rgb_u8, dtype=np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png wants (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(
        _PNG_SIG
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )


# ---------------------------------------------------------------------------
# minimal EXR reader: single-part scanline files, NONE/ZIP/ZIPS compression,
# HALF/FLOAT/UINT channels — the subset the reference's exr crate usage needs.

_PIXTYPE_SIZES = {0: 4, 1: 2, 2: 4}  # UINT, HALF, FLOAT


def _read_cstr(buf, off):
    end = buf.index(b"\0", off)
    return buf[off:end].decode("latin-1"), end + 1


def read_exr(path) -> np.ndarray:
    buf = Path(path).read_bytes()
    if buf[:4] != b"\x76\x2f\x31\x01":
        raise ValueError("not an EXR file")
    version = struct.unpack("<I", buf[4:8])[0]
    if version & 0x200:
        raise ValueError("tiled/deep EXR not supported")
    off = 8
    attrs = {}
    while True:
        if buf[off] == 0:
            off += 1
            break
        name, off = _read_cstr(buf, off)
        atype, off = _read_cstr(buf, off)
        size = struct.unpack("<I", buf[off : off + 4])[0]
        off += 4
        attrs[name] = (atype, buf[off : off + size])
        off += size

    # channels
    chans = []
    cbuf = attrs["channels"][1]
    coff = 0
    while cbuf[coff] != 0:
        cname, coff = _read_cstr(cbuf, coff)
        ptype, _plin, _resx, _resy = struct.unpack("<IIII", cbuf[coff : coff + 16])
        coff += 16
        chans.append((cname, ptype))
    chans_sorted = sorted(chans)  # EXR stores channels alphabetically per scanline

    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    width, height = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][1][0]
    if comp not in (0, 2, 3):  # NONE, ZIPS, ZIP
        raise ValueError(f"unsupported EXR compression {comp}")
    lines_per_block = 1 if comp in (0, 2) else 16

    n_blocks = (height + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack("<%dQ" % n_blocks, buf[off : off + 8 * n_blocks])

    out = {c: np.zeros((height, width), np.float32) for c, _ in chans}
    bytes_per_line = sum(_PIXTYPE_SIZES[t] for _, t in chans) * width
    for bo in offsets:
        y = struct.unpack("<i", buf[bo : bo + 4])[0] - y0
        dsize = struct.unpack("<I", buf[bo + 4 : bo + 8])[0]
        data = buf[bo + 8 : bo + 8 + dsize]
        n_lines = min(lines_per_block, height - y)
        raw_size = bytes_per_line * n_lines
        if comp != 0 and dsize < raw_size:
            data = zlib.decompress(data)
            # EXR zip predictor: delta-decode then de-interleave
            d = bytearray(data)
            for i in range(1, len(d)):
                d[i] = (d[i] + d[i - 1] - 128) & 0xFF
            half = (len(d) + 1) // 2
            inter = bytearray(len(d))
            inter[0::2] = d[:half]
            inter[1::2] = d[half : half + len(d) - half]
            data = bytes(inter)
        pos = 0
        for line in range(n_lines):
            for cname, ptype in chans_sorted:
                sz = _PIXTYPE_SIZES[ptype] * width
                seg = data[pos : pos + sz]
                pos += sz
                if ptype == 1:
                    vals = np.frombuffer(seg, dtype=np.float16).astype(np.float32)
                elif ptype == 2:
                    vals = np.frombuffer(seg, dtype="<f4").astype(np.float32)
                else:
                    vals = np.frombuffer(seg, dtype="<u4").astype(np.float32)
                out[cname][y + line] = vals

    rgb = np.zeros((height, width, 3), np.float32)
    for i, c in enumerate("RGB"):
        if c in out:
            rgb[..., i] = out[c]
        elif "Y" in out:
            rgb[..., i] = out["Y"]
    return rgb

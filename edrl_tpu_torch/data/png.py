"""PNG decoding and encoding in numpy and the standard library.

``read_png`` is the port's counterpart of ``cv2.imread(path)[..., ::-1]``
(``edrl_tpu/data/gamma.py:47-53``), which reads a fundus photograph as
``IMREAD_COLOR`` does and flips BGR to RGB.  It gives what OpenCV gives for
every PNG that OpenCV reads: colour types 0, 2, 3, 4 and 6 at every bit
depth; 16-bit samples reduced to 8 by dropping the low byte (libpng's
``png_set_strip_16``); gray replicated to three channels, 1-, 2- and 4-bit
gray scaled to 8 bits; palettes expanded; alpha channels and ``tRNS``
dropped, not composited; ``gAMA``, ``sBIT`` and the other ancillary chunks
ignored.  Every chunk's CRC is checked, and a file that cannot be decoded
raises ``ValueError`` naming the file and the reason.  Interlaced (Adam7)
files are refused.  ``check_png`` makes every one of those checks but
skips the unfiltering, which cannot fail, so a preflight of a tree costs
the inflate of each file and not its decode.

The five row filters are undone exactly by an anti-diagonal wavefront: the
byte unit at (row r, unit u) depends only on (r, u - 1), (r - 1, u) and
(r - 1, u - 1), so every unit of one diagonal r + u = t is one vector step
over the rows (each with its own filter type) and the bytes of a pixel.
The rows are held skewed (row r shifted by r units) so that a diagonal is
one contiguous slice.

``write_png`` writes fixtures, choosing the filter type per row, so that
tests and the chip smoke exercise all five filters without OpenCV or PIL.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Samples per pixel and the bit depths the standard allows, by colour type.
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _chunks(raw: bytes, path: str):
    """(type, data) of each chunk up to IEND, each CRC checked."""
    if raw[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (bad signature)")
    view = memoryview(raw)
    pos = 8
    while pos + 12 <= len(raw):
        (length,) = struct.unpack_from(">I", raw, pos)
        ctype = bytes(view[pos + 4 : pos + 8])
        end = pos + 8 + length
        if end + 4 > len(raw):
            break
        data = view[pos + 8 : end]
        (crc,) = struct.unpack_from(">I", raw, end)
        if zlib.crc32(data, zlib.crc32(ctype)) != crc:
            raise ValueError(f"{path}: bad CRC in the {ctype.decode('latin-1')!r} chunk at byte {pos}")
        yield ctype, data
        if ctype == b"IEND":
            return
        pos = end + 4
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray, out: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int16 operands into ``out`` (ties go to a, then b)."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    np.copyto(out, c)
    np.copyto(out, b, where=pb <= pc)
    np.copyto(out, a, where=(pa <= pb) & (pa <= pc))
    return out


def _skewed(buf: np.ndarray, h: int, units: int, bpp: int) -> np.ndarray:
    """The [h, units, bpp] view of a [h + units + 1, h + 1, bpp] buffer in
    which unit (r, u) lies at diagonal r + u + 1, row r + 1."""
    item = buf.itemsize
    return np.lib.stride_tricks.as_strided(
        buf[1:, 1:], shape=(h, units, bpp),
        strides=((h + 2) * bpp * item, (h + 1) * bpp * item, item))


def _unfilter(filtered: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters: ``filtered`` [h, length] uint8 (the filter-type
    bytes removed), ``types`` [h] in 0..4, ``bpp`` the bytes of one pixel
    (at least 1).  Returns the [h, length] raw bytes."""
    h, length = filtered.shape
    units = length // bpp
    # Diagonal t of the skewed buffers holds the units with r + u = t - 1.
    # Diagonal 0, row 0 and the last diagonal (never written, so s[-1] reads
    # zeros at t = 1) are the zeros the filters read beyond the image.
    f = np.zeros((h + units + 1, h + 1, bpp), np.int16)
    _skewed(f, h, units, bpp)[...] = filtered.reshape(h, units, bpp)
    s = np.zeros_like(f)
    # One diagonal's prediction under each filter type, in one buffer, and
    # for each unit the flat index of its row's type there.
    cand = np.zeros((5, h, bpp), np.int16)
    flat = cand.reshape(-1)
    pick = (np.repeat(types.astype(np.intp), bpp) * (h * bpp) + np.arange(h * bpp)).reshape(h, bpp)
    for d in range(1, h + units):
        a, b, c = s[d - 1, 1:], s[d - 1, :-1], s[d - 2, :-1]
        np.copyto(cand[1], a)
        np.copyto(cand[2], b)
        np.add(a, b, out=cand[3])
        cand[3] >>= 1
        _paeth(a, b, c, cand[4])
        np.add(f[d, 1:], flat[pick], out=s[d, 1:])
        s[d, 1:] &= 0xFF
    return _skewed(s, h, units, bpp).reshape(h, length).astype(np.uint8)


def _unpack(rows: np.ndarray, depth: int, count: int) -> np.ndarray:
    """[h, bytes] -> [h, count] samples of ``depth`` bits (below 8)."""
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return samples.reshape(rows.shape[0], -1)[:, :count]


def _rows(path: str):
    """The IHDR fields, the palette and the [height, row bytes + 1] filtered
    rows (each led by its filter-type byte) of a PNG file.  Every check that
    decoding can fail is made here: the signature, every chunk's CRC, the
    header, the palette, the inflate, the stream's length and the filter
    types.  Undoing the filters cannot fail."""
    with open(path, "rb") as f:
        raw = f.read()
    header, palette, idat = None, None, []
    for ctype, data in _chunks(raw, path):
        if ctype == b"IHDR":
            if len(data) != 13:
                raise ValueError(f"{path}: IHDR of {len(data)} bytes, want 13")
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(data)
        elif not ctype[0] & 0x20 and ctype != b"IEND":
            raise ValueError(f"{path}: unknown critical chunk {ctype.decode('latin-1')!r}")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color] or not width or not height:
        raise ValueError(f"{path}: a {width}x{height} image of colour type {color} at bit depth {depth} "
                         "is not valid PNG")
    if compression or filter_method:
        raise ValueError(f"{path}: unknown compression {compression} or filter method {filter_method}")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported; save it without interlacing")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: a palette image with no PLTE chunk")
    row_bytes = (width * _CHANNELS[color] * depth + 7) // 8
    try:
        stream = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"{path}: corrupt image data ({exc})") from None
    if len(stream) < height * (row_bytes + 1):
        raise ValueError(f"{path}: image data is {len(stream)} bytes, want {height * (row_bytes + 1)}")
    rows = np.frombuffer(stream, np.uint8, count=height * (row_bytes + 1)).reshape(height, row_bytes + 1)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter type {int(rows[:, 0].max())}")
    return header, palette, rows


def check_png(path: str) -> Tuple[int, int]:
    """(height, width) of a PNG that ``read_png`` decodes, else the
    ``ValueError`` that ``read_png`` raises: every check of the decode but
    the unfiltering, in the time of the inflate."""
    width, height = _rows(path)[0][:2]
    return height, width


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] float32 RGB in 0..255, as ``cv2.imread(path)[..., ::-1]``."""
    (width, height, depth, color, *_), palette, rows = _rows(path)
    channels = _CHANNELS[color]
    data = _unfilter(rows[:, 1:], rows[:, 0], max(1, channels * depth // 8))
    if depth == 16:
        samples = data[:, 0::2]  # the high byte of each big-endian sample
    elif depth == 8:
        samples = data
    else:
        samples = _unpack(data, depth, width * channels)
    samples = samples.reshape(height, width, channels)
    if color == 3:
        lut = np.zeros((256, 3), np.uint8)  # indices past the palette read black
        lut[: min(len(palette), 256)] = palette[:256]
        rgb = lut[samples[..., 0]]
    elif color in (0, 4):
        gray = samples[..., 0]
        if depth < 8:
            gray = gray * np.uint8(255 // ((1 << depth) - 1))
        rgb = np.repeat(gray[..., None], 3, axis=-1)
    else:
        rgb = samples[..., :3]
    return rgb.astype(np.float32)


def _filter_rows(data: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Apply each row's filter to the raw [h, length] bytes."""
    x = data.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:] = left[:-1]
    out = x.copy()
    for kind, pred in ((1, lambda m: left[m]), (2, lambda m: up[m]),
                       (3, lambda m: (left[m] + up[m]) >> 1),
                       (4, lambda m: _paeth(left[m], up[m], upleft[m], np.empty_like(x[m])))):
        m = types == kind
        if m.any():
            out[m] = x[m] - pred(m)
    return (out & 0xFF).astype(np.uint8)


def write_png(path: str, img: np.ndarray, *, filters: Sequence[int] = (0, 1, 2, 3, 4),
              bit_depth: Optional[int] = None, palette: Optional[np.ndarray] = None,
              trns: Optional[bytes] = None) -> None:
    """Write ``img`` as a PNG, row r filtered with ``filters[r % len(filters)]``.

    ``img``: [H, W] or [H, W, C] samples, C = 1 (gray), 2 (gray + alpha), 3
    (RGB) or 4 (RGBA), uint8 or uint16 (bit depth 8 or 16 unless
    ``bit_depth`` says 1, 2 or 4); with ``palette`` ([N, 3] uint8) ``img`` is
    [H, W] palette indices.  ``trns``: the raw data of a ``tRNS`` chunk.
    """
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if palette is not None:
        color = 3
    else:
        color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    depth = bit_depth or (16 if img.dtype == np.uint16 else 8)
    if depth not in _DEPTHS[color] or (color == 3 and c != 1):
        raise ValueError(f"colour type {color} at bit depth {depth} with {c} channels is not valid PNG")
    if depth == 16:
        data = img.astype(">u2").view(np.uint8).reshape(h, -1)
    elif depth == 8:
        data = img.astype(np.uint8).reshape(h, -1)
    else:
        per_byte = 8 // depth
        samples = img.reshape(h, -1).astype(np.uint8)
        pad = -samples.shape[1] % per_byte
        samples = np.pad(samples, ((0, 0), (0, pad))).reshape(h, -1, per_byte)
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        data = np.bitwise_or.reduce(samples << shifts, axis=-1).astype(np.uint8)
    types = np.resize(np.asarray(filters, np.uint8), h)
    rows = np.concatenate([types[:, None], _filter_rows(data, types, max(1, c * depth // 8))], axis=1)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(
            ">I", zlib.crc32(payload, zlib.crc32(ctype)))

    parts = [_SIGNATURE, chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))]
    if palette is not None:
        parts.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        parts.append(chunk(b"tRNS", trns))
    parts += [chunk(b"IDAT", zlib.compress(rows.tobytes())), chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(parts))

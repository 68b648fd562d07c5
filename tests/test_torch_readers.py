"""The port's real-data readers against the JAX package's, on the CPU.

``edrl_tpu_torch.data`` reads GAMMA / Harvard trees with no cv2, PIL or
pandas: ``png.read_png`` stands for ``cv2.imread(path)[..., ::-1]``,
``transforms.resize_image`` for ``cv2.resize(..., INTER_CUBIC)`` and
``gamma.read_csv`` for ``pd.read_csv``.  Here, where all three are
installed, each is held to what the JAX package gets from them: the NIfTI
and xlsx copies, ``read_png``, the csv labels and ``GammaDataset.get``
exactly; ``resize_image`` within 1e-6 of OpenCV's, with at most 1e-4 of the
uint8 bytes one apart.
"""

import gzip
import re
import shutil
import struct
import subprocess
import sys
import zipfile
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from edrl_tpu.config import DataConfig as JaxDataConfig
from edrl_tpu.data import gamma as jgamma
from edrl_tpu.data import nifti as jnifti
from edrl_tpu.data import transforms as jtransforms
from edrl_tpu.data import xlsx as jxlsx
from edrl_tpu_torch.config import DataConfig
from edrl_tpu_torch.data import gamma, nifti, png, transforms, xlsx

REPO = Path(__file__).resolve().parents[1]
RESIZE_ATOL = 1e-6
RESIZE_BYTE_SHARE = 1e-4


def _cv2_rgb(path):
    return cv2.imread(str(path))[..., ::-1].astype(np.float32)


# -- NIfTI ---------------------------------------------------------------------

def _nifti_bytes(vol, code, slope=1.0, inter=0.0):
    """A NIfTI-1 file of ``vol`` stored as datatype ``code`` (Fortran order)."""
    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    struct.pack_into("<8h", header, 40, vol.ndim, *vol.shape, *[1] * (7 - vol.ndim))
    struct.pack_into("<h", header, 70, code)
    struct.pack_into("<f", header, 108, 352.0)
    struct.pack_into("<f", header, 112, slope)
    struct.pack_into("<f", header, 116, inter)
    header[344:348] = b"n+1\x00"
    return bytes(header) + vol.transpose(range(vol.ndim)[::-1]).tobytes()


NIFTI_CASES = {
    "f32": lambda r: (r.uniform(0, 255, (6, 5, 4)).astype(np.float32), 16, 1.0, 0.0),
    "uint8": lambda r: (r.integers(0, 256, (6, 5, 4)).astype(np.uint8), 2, 0.0, 0.0),
    "int16_slope_inter": lambda r: (r.integers(-900, 900, (6, 5, 4)).astype(np.int16), 4, 0.25, -3.5),
    "int16_inter_only": lambda r: (r.integers(-900, 900, (6, 5, 4)).astype(np.int16), 4, 1.0, -1024.0),
    "uint16_nan_scaling": lambda r: (r.integers(0, 60000, (6, 5, 4)).astype(np.uint16), 512, np.nan, np.nan),
    "f64_4d": lambda r: (r.normal(size=(4, 3, 5, 2)), 64, 2.0, 1.0),
}


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("case", sorted(NIFTI_CASES))
def test_read_nifti_equals_jax(tmp_path, rng, case, gz):
    vol, code, slope, inter = NIFTI_CASES[case](rng)
    raw = _nifti_bytes(vol, code, slope, inter)
    path = tmp_path / ("v.nii.gz" if gz else "v.nii")
    path.write_bytes(gzip.compress(raw) if gz else raw)
    ours, theirs = nifti.read_nifti(str(path)), jnifti.read_nifti(str(path))
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == vol.shape
    assert np.array_equal(ours, theirs)
    assert nifti._DTYPES == jnifti._DTYPES


def test_write_nifti_equals_jax(tmp_path, rng):
    vol = rng.uniform(0, 255, (7, 6, 5)).astype(np.float32)
    nifti.write_nifti(str(tmp_path / "a.nii"), vol)
    jnifti.write_nifti(str(tmp_path / "b.nii"), vol)
    assert (tmp_path / "a.nii").read_bytes() == (tmp_path / "b.nii").read_bytes()
    assert np.array_equal(nifti.read_nifti(str(tmp_path / "a.nii")), vol)


# -- xlsx ----------------------------------------------------------------------

def _xlsx_shared_strings(path, sheets):
    """An xlsx whose string cells are shared strings; ``sheets`` are lists of
    rows, written as sheet1.xml, sheet2.xml, ..."""
    ns = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
    strings = sorted({v for rows in sheets for row in rows for v in row if isinstance(v, str)})
    sst = "".join(f"<si><t>{s}</t></si>" if i % 2 else f"<si><r><t>{s[:1]}</t></r><r><t>{s[1:]}</t></r></si>"
                  for i, s in enumerate(strings))
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("xl/sharedStrings.xml", f'<sst xmlns="{ns}">{sst}</sst>')
        for n, rows in enumerate(sheets, start=1):
            body = []
            for r, row in enumerate(rows, start=1):
                cells = []
                for c, v in enumerate(row):
                    ref = f"{chr(ord('A') + c)}{r}"
                    if v is None:
                        continue
                    if isinstance(v, str):
                        cells.append(f'<c r="{ref}" t="s"><v>{strings.index(v)}</v></c>')
                    else:
                        cells.append(f'<c r="{ref}"><v>{v}</v></c>')
                body.append(f'<row r="{r}">{"".join(cells)}</row>')
            zf.writestr(f"xl/worksheets/sheet{n}.xml", f'<worksheet xmlns="{ns}"><sheetData>{"".join(body)}'
                        "</sheetData></worksheet>")


def test_xlsx_readers_equal_jax_on_shared_strings(tmp_path):
    path = str(tmp_path / "labels.xlsx")
    first = [["data", "class_0", "class_1", "note"], ["00001", 1, 0, "ok"], [2, 0, 1, None],
             ["00003", None, 1, "gap"], [4.0, 1, 0, "x"]]
    # Eleven sheets: the first is sheet1.xml, not sheet10.xml.
    _xlsx_shared_strings(path, [first] + [[["data"], [f"other{k}"]] for k in range(2, 12)])
    assert xlsx.read_xlsx_rows(path) == jxlsx.read_xlsx_rows(path)
    assert xlsx.read_xlsx_rows(path)[1] == ["00001", "1", "0", "ok"]
    assert xlsx.read_xlsx_dict(path) == jxlsx.read_xlsx_dict(path)
    with pytest.raises(ValueError, match="could not convert string to float: 'ok'"):
        jgamma.load_labels(path)
    with pytest.raises(ValueError, match="could not convert string to float: 'ok'"):
        gamma.load_labels(path)
    _xlsx_shared_strings(path, [[row[:3] for row in first]])
    ours, theirs = gamma.load_labels(path), jgamma.load_labels(path)
    assert list(ours) == list(theirs) == ["00001", "00002", "00003", "00004"]
    assert all(np.array_equal(ours[k], theirs[k]) for k in ours)


def test_write_xlsx_reads_back_as_jax_s(tmp_path):
    rows = [["00007", 0, 1], ["00008", 1.5, 0], ["a9", None, 1]]
    xlsx.write_xlsx(str(tmp_path / "a.xlsx"), ["data", "class_0", "class_1"], rows)
    jxlsx.write_xlsx(str(tmp_path / "b.xlsx"), ["data", "class_0", "class_1"], rows)
    with zipfile.ZipFile(tmp_path / "a.xlsx") as a, zipfile.ZipFile(tmp_path / "b.xlsx") as b:
        assert {n: a.read(n) for n in a.namelist()} == {n: b.read(n) for n in b.namelist()}
    assert xlsx.read_xlsx_rows(str(tmp_path / "a.xlsx")) == jxlsx.read_xlsx_rows(str(tmp_path / "b.xlsx"))


# -- PNG -----------------------------------------------------------------------

# (colour type, bit depth) of every PNG the standard allows.
PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4), (3, 8),
             (4, 8), (4, 16), (6, 8), (6, 16)]


def _png_samples(rng, color, depth, h=11, w=13):
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    top = 2 ** depth
    img = rng.integers(0, top, (h, w, channels)).astype(np.uint16 if depth == 16 else np.uint8)
    palette = rng.integers(0, 256, (min(top, 200), 3)).astype(np.uint8) if color == 3 else None
    if color == 3:
        img = img % len(palette)
    return img, palette


@pytest.mark.parametrize("filters", [(0, 1, 2, 3, 4), (0,), (1,), (2,), (3,), (4,)])
@pytest.mark.parametrize("color,depth", PNG_KINDS)
def test_read_png_equals_cv2_on_written_pngs(tmp_path, rng, color, depth, filters):
    img, palette = _png_samples(rng, color, depth)
    path = str(tmp_path / "x.png")
    png.write_png(path, img, filters=filters, bit_depth=depth, palette=palette)
    ours = png.read_png(path)
    assert ours.dtype == np.float32 and ours.shape == img.shape[:2] + (3,)
    assert np.array_equal(ours, _cv2_rgb(path))
    assert png.check_png(path) == img.shape[:2]


@pytest.mark.parametrize("color,trns", [(0, struct.pack(">H", 3)), (2, struct.pack(">HHH", 1, 2, 3)),
                                        (3, bytes(range(0, 250, 25)))])
def test_read_png_drops_trns_as_cv2_does(tmp_path, rng, color, trns):
    img, palette = _png_samples(rng, color, 8)
    path = str(tmp_path / "t.png")
    png.write_png(path, img, palette=palette, trns=trns)
    assert np.array_equal(png.read_png(path), _cv2_rgb(path))


def _photo(rng, h, w):
    """A smooth, structured RGB image (it compresses as a photograph does)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = sum(np.sin(x * rng.uniform(0.01, 0.05) + y * rng.uniform(0.01, 0.05) + rng.uniform(0, 6))[..., None]
              * rng.uniform(20, 60, 3) for _ in range(3))
    return np.clip(img + 128 + rng.normal(0, 3, (h, w, 3)), 0, 255).astype(np.uint8)


WRITERS = {
    "cv2_bgr": lambda p, im: cv2.imwrite(p, im[..., ::-1]),
    "cv2_gray": lambda p, im: cv2.imwrite(p, im[..., 0]),
    "cv2_bgra": lambda p, im: cv2.imwrite(p, np.concatenate([im, im[..., :1]], -1)),
    "cv2_bgr16": lambda p, im: cv2.imwrite(p, im.astype(np.uint16) * 257 + 11),
    "cv2_gray16": lambda p, im: cv2.imwrite(p, im[..., 1].astype(np.uint16) * 250),
    "cv2_bilevel": lambda p, im: cv2.imwrite(p, (im[..., 0] > 128).astype(np.uint8) * 255,
                                             [cv2.IMWRITE_PNG_BILEVEL, 1]),
    "pil_rgb": lambda p, im: Image.fromarray(im).save(p),
    "pil_rgba": lambda p, im: Image.fromarray(np.concatenate([im, im[..., 2:]], -1)).save(p),
    "pil_l": lambda p, im: Image.fromarray(im[..., 0]).save(p),
    "pil_la": lambda p, im: Image.fromarray(im[..., :2]).save(p),
    "pil_1bit": lambda p, im: Image.fromarray(im[..., 0]).convert("1").save(p),
    "pil_palette": lambda p, im: Image.fromarray(im).quantize(37).save(p),
    "pil_palette_4bit_trns": lambda p, im: Image.fromarray(im).quantize(12).save(p, bits=4, transparency=3),
    "pil_i16": lambda p, im: Image.fromarray(im[..., 0].astype(np.uint16) * 256 + 7).save(p),
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_read_png_equals_cv2_on_cv2_and_pil_files(tmp_path, rng, writer):
    path = str(tmp_path / f"{writer}.png")
    WRITERS[writer](path, _photo(rng, 37, 53))
    assert np.array_equal(png.read_png(path), _cv2_rgb(path))


def test_read_png_refuses_bad_crc_and_interlace(tmp_path, rng):
    path = tmp_path / "ok.png"
    png.write_png(str(path), rng.integers(0, 256, (9, 8, 3), dtype=np.uint8))
    raw = bytearray(path.read_bytes())
    idat = raw.index(b"IDAT")
    bad = bytearray(raw)
    bad[idat + 6] ^= 0x01
    (tmp_path / "bad.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match=r"bad\.png: bad CRC in the 'IDAT' chunk"):
        png.read_png(str(tmp_path / "bad.png"))
    assert cv2.imread(str(tmp_path / "bad.png")) is None
    # Interlace byte set in IHDR (and its CRC made good): refused by name.
    ihdr = raw.index(b"IHDR")
    raw[ihdr + 4 + 12] = 1
    raw[ihdr + 17: ihdr + 21] = struct.pack(">I", zlib.crc32(bytes(raw[ihdr: ihdr + 17])))
    (tmp_path / "adam7.png").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match=r"adam7\.png: interlaced \(Adam7\)"):
        png.read_png(str(tmp_path / "adam7.png"))
    (tmp_path / "trunc.png").write_bytes(path.read_bytes()[:-20])
    with pytest.raises(ValueError, match="trunc.png: truncated"):
        png.read_png(str(tmp_path / "trunc.png"))


def _chunk(ctype, payload):
    return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", zlib.crc32(payload, zlib.crc32(ctype)))


def _handmade_png(path, *, depth=8, color=2, interlace=0, plte=None, stream=None, idat=None, extra=b"",
                  signature=png._SIGNATURE, cut=0, flip_crc=False):
    """A 9 x 8 PNG built chunk by chunk, so that each fault can be planted."""
    height, width = 9, 8
    if stream is None:
        stream = bytes(height * (1 + width * 3))
    body = [_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, interlace))]
    if plte is not None:
        body.append(_chunk(b"PLTE", plte))
    body += [extra, _chunk(b"IDAT", zlib.compress(stream) if idat is None else idat), _chunk(b"IEND", b"")]
    raw = bytearray(signature + b"".join(body))
    if flip_crc:
        raw[raw.index(b"IDAT") + 6] ^= 0x01
    path.write_bytes(bytes(raw[: len(raw) - cut]))


# fault -> (how the file is built, what the error says)
PNG_FAULTS = {
    "signature": (dict(signature=b"GIF89a\x00\x00"), "not a PNG file"),
    "bad_crc": (dict(flip_crc=True), "bad CRC in the 'IDAT' chunk"),
    "truncated": (dict(cut=20), "truncated PNG"),
    "unknown_critical_chunk": (dict(extra=_chunk(b"ABCD", b"x")), "unknown critical chunk 'ABCD'"),
    "bit_depth": (dict(depth=4), "colour type 2 at bit depth 4 is not valid PNG"),
    "adam7": (dict(interlace=1), r"interlaced \(Adam7\)"),
    "palette_missing": (dict(color=3), "a palette image with no PLTE chunk"),
    "inflate": (dict(idat=b"not zlib"), "corrupt image data"),
    "short_stream": (dict(stream=bytes(100)), "image data is 100 bytes, want 225"),
    "filter_type": (dict(stream=b"\x05" + bytes(9 * 25 - 1)), "unknown row filter type 5"),
}


@pytest.mark.parametrize("fault", sorted(PNG_FAULTS))
def test_check_png_refuses_what_read_png_refuses(tmp_path, fault):
    """``check_png`` (the preflight's image check) raises the very error
    ``read_png`` raises on each fault it can meet, naming the file."""
    build, says = PNG_FAULTS[fault]
    path = tmp_path / f"{fault}.png"
    _handmade_png(path, **build)
    with pytest.raises(ValueError) as theirs:
        png.read_png(str(path))
    with pytest.raises(ValueError, match=f"{fault}\\.png: .*{says}") as ours:
        png.check_png(str(path))
    assert str(ours.value) == str(theirs.value)


def test_read_png_of_a_fundus_size_photograph(tmp_path, rng):
    """2000 x 2992, every filter type: the port's file equals its pixels and
    cv2's read; cv2's own file (its filter choice) reads as cv2 reads it."""
    img = _photo(rng, 2000, 2992)
    path = str(tmp_path / "f.png")
    png.write_png(path, img)
    ours = png.read_png(path)
    assert np.array_equal(ours, img) and np.array_equal(ours, _cv2_rgb(path))
    cv2.imwrite(path, img[..., ::-1])
    assert np.array_equal(png.read_png(path), img)


# -- resize --------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2000, 2992), (512, 640), (200, 300), (384, 384)])
def test_resize_image_within_the_bar_of_cv2(rng, shape):
    img = rng.uniform(size=shape + (3,)).astype(np.float32)
    ours = transforms.resize_image(img, 384)
    theirs = jtransforms.resize_image(img, 384)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == theirs.shape == (384, 384, 3)
    assert np.abs(ours - theirs).max() <= RESIZE_ATOL

    def u8(x):
        return np.rint(np.clip(x, 0, 1) * 255).astype(np.int16)

    diff = np.abs(u8(ours) - u8(theirs))
    assert diff.max() <= 1 and (diff > 0).mean() <= RESIZE_BYTE_SHARE


def test_resize_volume_and_zoom_indices_equal_jax(rng):
    vol = rng.uniform(0, 255, (20, 17, 9)).astype(np.float32)
    for shape in [(8, 8, 8), (20, 17, 9), (33, 5, 12)]:
        assert np.array_equal(transforms.resize_volume(vol, shape), jtransforms.resize_volume(vol, shape))
    for d, od in [(256, 96), (200, 96), (5, 9), (7, 1), (4, 0)]:
        assert np.array_equal(transforms._zoom_indices(d, od), jtransforms._zoom_indices(d, od))


# -- csv labels ----------------------------------------------------------------

CSV_CASES = {
    "int_ids": "data,class_0,class_1\n1,0,1\n00002,1,0\n+3,0,1\n",
    "empty_cell": "data,class_0,class_1\n1,0,1\n2,1,\n",
    "padded_string_ids": "data,class_0,class_1\n00001,0,1\na2,1,0\n",
    "float_ids": "data,class_0,class_1\n1.0,0,1\n2,1,0\n",
    "empty_id": "data,class_0,class_1\n,0,1\n2,1,0\n",
    "float_labels": "data,class_0,class_1\n1,0.5,0.5\n2,1e0,0\n",
    "bool_labels": "data,class_0,class_1\n1,True,False\n2,false,TRUE\n",
    "short_row_and_blank_line": "data,class_0,class_1\n1,0\n\n2,1,0\n",
    "na_words": "data,class_0,class_1\n1,NA,1\n2,1,null\n3,inf,-1\n",
    "quoted": 'data,class_0,class_1\n"00001",0,"1"\n2,1,0\n',
    "non_numeric": "data,class_0,class_1\n1,0,1\n2,1,oops\n3,0,1\n",
    "no_data_column": "id,class_0\n1,0\n",
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_csv_labels_and_ids_equal_jax(tmp_path, case):
    """``load_labels`` as JAX's (pandas ``iterrows``), the glu2 id list as
    ``pd.read_csv(...)["data"].astype(str)``; a failure raises what pandas
    raises there, with its message."""
    import pandas as pd

    path = tmp_path / "labels.csv"
    path.write_text(CSV_CASES[case])
    try:
        theirs = jgamma.load_labels(str(path))
    except Exception as exc:  # noqa: BLE001 - the port must raise the same
        with pytest.raises(type(exc), match=re.escape(str(exc))):
            gamma.load_labels(str(path))
        return
    ours = gamma.load_labels(str(path))
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k], equal_nan=True)
    want = [str(x) for x in pd.read_csv(path)["data"].astype(str).values]
    assert gamma.csv_ids(str(path)) == want


# -- GammaDataset ----------------------------------------------------------------

def _tree(root, rng, n=6, size=32, vol_shape=(12, 11, 10), photo_size=None):
    """A dr2 tree: ids 1..n, the even ones zero-padded on disk, sample 3 on
    the processed_data_ fallback; csv and xlsx labels; returns the two
    label files."""
    rows = []
    for i in range(1, n + 1):
        sid = str(i).zfill(5) if i % 2 == 0 else str(i)
        d = root / sid
        d.mkdir(parents=True)
        img = (_photo(rng, *photo_size) if photo_size and i == 1
               else rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
        png.write_png(str(d / f"data_{sid}_fundus.png"), img)
        vol = rng.integers(0, 256, vol_shape).astype(np.float32)
        nifti.write_nifti(str(d / (f"processed_data_{sid}.nii" if i == 3 else f"data_{sid}.nii")), vol)
        rows.append([str(i).zfill(5), int(i % 3 == 0), int(i % 3 == 1), int(i % 3 == 2)])
    header = ["data", "class_0", "class_1", "class_2"]
    xlsx.write_xlsx(str(root.parent / "labels.xlsx"), header, rows)
    (root.parent / "labels.csv").write_text(",".join(header) + "\n" + "".join(
        ",".join(map(str, r)) + "\n" for r in rows))
    return str(root.parent / "labels.csv"), str(root.parent / "labels.xlsx")


def _pair(root, label_file, mode, cache=True, filelists=None, **kw):
    kw = dict(dataset="dr2", data_path=str(root), label_file=label_file, fundus_size=32, oct_size=(8, 8, 8),
              **kw)
    return (gamma.GammaDataset(DataConfig(**kw), mode=mode, cache=cache, filelists=filelists),
            jgamma.GammaDataset(JaxDataConfig(**kw), mode=mode, cache=cache, filelists=filelists))


@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("device_noise,uint8", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("mode", ["train", "val"])
def test_gamma_dataset_get_equals_jax(tmp_path, rng, mode, device_noise, uint8, cache):
    """Each package reads its own copy of one tree: epoch 0 misses the cache
    (when on) and writes it, epoch 1 hits it; the samples, their order and
    every array are equal, byte for byte."""
    labels, _ = _tree(tmp_path / "a" / "data", rng)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    kw = dict(device_noise=device_noise, uint8_transport=uint8)
    ours, _ = _pair(tmp_path / "a" / "data", labels, mode, cache, **kw)
    _, theirs = _pair(tmp_path / "b" / "data", str(tmp_path / "b" / "labels.csv"), mode, cache, **kw)
    assert [s[0] for s in ours.samples] == [s[0] for s in theirs.samples] == ["00002", "00004", "00006", "1", "3", "5"]
    for epoch in (0, 1):
        for i in range(len(ours)):
            a, b = ours.get(i, epoch), theirs.get(i, epoch)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (k, epoch, i)
    caches = sorted(p.name for p in (tmp_path / "a" / "data").rglob("_edrl_cache8_*"))
    assert caches == (["_edrl_cache8_32_8x8x8.npz"] * 6 if cache else [])


def test_gamma_dataset_ids_and_xlsx_labels_equal_jax(tmp_path, rng):
    _, labels = _tree(tmp_path / "data", rng)
    for filelists in (None, ["1", "00002", "3", "4", "77", "00005"]):
        ours, theirs = _pair(tmp_path / "data", labels, "val", False, filelists)
        assert repr(ours.samples) == repr(theirs.samples)
        for i in range(len(ours)):
            assert all(np.array_equal(ours.get(i)[k], theirs.get(i)[k]) for k in ours.get(i))


def test_gamma_dataset_fundus_size_sample_at_the_resize_bar(tmp_path, rng):
    """A 2000 x 2992 fundus resized to 384: the uint8 cache bytes within the
    resize bar of JAX's (cv2's), the volume equal."""
    labels, _ = _tree(tmp_path / "data", rng, n=1, photo_size=(2000, 2992))
    kw = dict(fundus_size=384, oct_size=(8, 8, 8), device_noise=True, uint8_transport=True)
    cfg = dict(dataset="dr2", data_path=str(tmp_path / "data"), label_file=labels, **kw)
    a = gamma.GammaDataset(DataConfig(**cfg), cache=False).get(0)
    b = jgamma.GammaDataset(JaxDataConfig(**cfg), cache=False).get(0)
    assert np.array_equal(a["oct"], b["oct"]) and a["fundus"].shape == b["fundus"].shape == (384, 384, 3)
    diff = np.abs(a["fundus"].astype(np.int16) - b["fundus"])
    assert diff.max() <= 1 and (diff > 0).mean() <= RESIZE_BYTE_SHARE


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_caches_serve_both_packages(tmp_path, rng, writer):
    """A cache written by one package's dataset is read by the other's (a
    hit: the sources are removed first) as the writer reads it back."""
    labels, _ = _tree(tmp_path / "data", rng)
    ours, theirs = _pair(tmp_path / "data", labels, "val", True, device_noise=True, uint8_transport=True)
    first, second = (theirs, ours) if writer == "jax" else (ours, theirs)
    for i in range(len(first)):
        first.get(i)
    for p in (tmp_path / "data").rglob("*.png"):
        p.unlink()
    for i in range(len(first)):
        a, b = first.get(i), second.get(i)
        assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
    with np.load(next((tmp_path / "data").rglob("_edrl_cache8_*"))) as z:
        assert sorted(z.files) == ["fundus", "oct"] and z["fundus"].dtype == np.uint8


def test_gamma_sub1_dataset_equals_jax(tmp_path, rng):
    """The glu2 legacy layout: the fundus through the port's PNG reader, the
    OCT slices through PIL (as in the JAX package); train and val."""
    root = tmp_path / "data"
    for i, size in ((1, (40, 44)), (2, (2000, 2100))):
        sid = str(i)
        (root / sid / sid).mkdir(parents=True)
        png.write_png(str(root / sid / f"{sid}.png"), _photo(rng, *size))
        for s in (1, 2, 10):
            Image.fromarray(rng.integers(0, 256, (9, 7), dtype=np.uint8)).save(root / sid / sid / f"{s}.png")
    (tmp_path / "l.csv").write_text("data,class_0,class_1\n00001,1,0\n00002,0,1\n")
    kw = dict(dataset="glu2", data_path=str(root), label_file=str(tmp_path / "l.csv"), fundus_size=48,
              oct_size=(4, 4, 4))
    for mode in ("train", "val"):
        ours = gamma.GammaSub1Dataset(DataConfig(**kw), mode=mode)
        theirs = jgamma.GammaSub1Dataset(JaxDataConfig(**kw), mode=mode)
        for i in range(2):
            a, b = ours.get(i, 1), theirs.get(i, 1)
            assert np.array_equal(a["oct"], b["oct"]) and a["label"] == b["label"]
            assert np.abs(a["fundus"] - b["fundus"]).max() <= RESIZE_ATOL * (1 if mode == "val" else 10)
    assert [gamma._slice_sort_key(n) for n in ("2.jpg", "10.jpg", "a.jpg")] == [
        jgamma._slice_sort_key(n) for n in ("2.jpg", "10.jpg", "a.jpg")]
    img = rng.uniform(size=(7, 9, 3)).astype(np.float32)
    for size in (4, 8, 12):
        assert np.array_equal(gamma.center_crop(img, size), jgamma.center_crop(img, size))


# -- no cv2, PIL or pandas -------------------------------------------------------

HERMETIC = r"""
import sys
for name in ("cv2", "PIL", "pandas"):
    sys.modules[name] = None
from edrl_tpu_torch.cli import train as train_cli
from edrl_tpu_torch.data.gamma import GammaDataset, _read_image
from edrl_tpu_torch.data.verify import verify_tree
from edrl_tpu_torch.config import DataConfig, EDRLConfig

root, csv_file, xlsx_file, jpg = sys.argv[1:]
for label_file in (csv_file, xlsx_file):
    cfg = DataConfig(dataset="dr2", data_path=root, label_file=label_file, fundus_size=32, oct_size=(8, 8, 8),
                     device_noise=True, batch_size=2)
    assert verify_tree(cfg, deep=True).ok
    ds = GammaDataset(cfg, mode="train", cache=False)
    assert len(ds) == 6 and all(ds.get(i)["fundus"].shape == (32, 32, 3) for i in range(len(ds)))
    for dataset in ("dr2", "glu2"):
        c = EDRLConfig().replace(data=DataConfig(dataset=dataset, data_path=root, label_file=label_file,
                                                 fundus_size=32, oct_size=(8, 8, 8), device_noise=True,
                                                 batch_size=2))
        train, val = train_cli.make_loaders(c)
        next(iter(train.epoch(0)))
try:
    _read_image(jpg)
except ImportError as exc:
    assert jpg in str(exc) and "PIL" in str(exc), exc
else:
    raise AssertionError("a JPEG read without PIL")
print("loaded:", sorted(n for n, m in sys.modules.items()
                        if m is not None and n.split(".")[0] in ("cv2", "PIL", "pandas")))
"""


def test_the_real_data_path_needs_no_cv2_pil_or_pandas(tmp_path, rng):
    csv_file, xlsx_file = _tree(tmp_path / "data", rng)
    jpg = tmp_path / "slice.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0")
    out = subprocess.run([sys.executable, "-c", HERMETIC, str(tmp_path / "data"), csv_file, xlsx_file, str(jpg)],
                         capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded: []"

"""Minimal NIfTI-1 volume reader and writer (``edrl_tpu/data/nifti.py``, copied).

The reference loads OCT volumes with nibabel (``code/data_harvard.py:678``);
the port does not depend on nibabel, and the loader only needs raw voxel
data, so this module parses the NIfTI-1 header directly (348-byte header,
optionally gzipped, magic ``n+1``/``ni1``).
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}


def read_nifti(path: str) -> np.ndarray:
    """Read a .nii / .nii.gz volume; returns data in stored (x, y, z) order
    with scl_slope/scl_inter applied when set."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    dim = struct.unpack_from("<8h", raw, 40)
    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])
    datatype = struct.unpack_from("<h", raw, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = _DTYPES[datatype]
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0]) or 352
    scl_slope = struct.unpack_from("<f", raw, 112)[0]
    scl_inter = struct.unpack_from("<f", raw, 116)[0]
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    # NIfTI stores Fortran (column-major) order: first axis fastest.
    vol = data.reshape(shape[::-1]).transpose(range(ndim)[::-1])
    vol = vol.astype(np.float32)
    # NIfTI-1 scaling semantics: apply whenever slope != 0 (slope == 0
    # means "no scaling stored").  slope == 1 does NOT skip the intercept —
    # pure-offset volumes (slope 1, inter -1024) are common in conversions.
    # NaN slope/inter mean unset (nibabel convention).
    if not np.isfinite(scl_slope):
        scl_slope = 0.0
    if not np.isfinite(scl_inter):
        scl_inter = 0.0
    if scl_slope != 0.0 and (scl_slope != 1.0 or scl_inter != 0.0):
        vol = vol * scl_slope + scl_inter
    return vol


def write_nifti(path: str, vol: np.ndarray) -> None:
    """Write a float32 NIfTI-1 file (for test fixtures and preprocessing)."""
    vol = np.asarray(vol, dtype=np.float32)
    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    ndim = vol.ndim
    dims = [ndim] + list(vol.shape) + [1] * (7 - ndim)
    struct.pack_into("<8h", header, 40, *dims)
    struct.pack_into("<h", header, 70, 16)  # float32
    struct.pack_into("<h", header, 72, 32)  # bitpix
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, 1.0)  # scl_slope
    pixdims = [1.0] * 8
    struct.pack_into("<8f", header, 76, *pixdims)
    header[344:348] = b"n+1\x00"
    with open(path, "wb") as f:
        f.write(bytes(header))
        # Fortran order: first axis fastest.
        f.write(vol.transpose(range(ndim)[::-1]).tobytes())

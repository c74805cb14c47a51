"""Minimal pure-NumPy NIfTI-1 codec (the port's).

A copy of ``brainiak_tpu.nifti``: the same header layout, dtypes,
scaling and affines, and the same error texts, so a file either
package writes the other reads, and a malformed file fails alike in
both.  Supports single-file ``.nii`` / ``.nii.gz`` (magic ``n+1``)
and header-pair magic ``ni1`` data read, the common dtypes,
scl_slope/scl_inter scaling, and sform/qform/pixdim affines.  Reads
retry transient failures through
:func:`brainiak_tpu_torch.resilience.retry.retry`, with the fault
hook ``faults.io_point(path, site="nifti.read")``.
"""

import gzip
import struct
import zlib

import numpy as np
import torch

from .resilience import faults
from .resilience.retry import retry

__all__ = ["NiftiImage", "load", "save"]

_DTYPES = {
    2: np.dtype(np.uint8),
    4: np.dtype(np.int16),
    8: np.dtype(np.int32),
    16: np.dtype(np.float32),
    64: np.dtype(np.float64),
    256: np.dtype(np.int8),
    512: np.dtype(np.uint16),
    768: np.dtype(np.uint32),
    1024: np.dtype(np.int64),
    1280: np.dtype(np.uint64),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}

_HDR_SIZE = 348


class NiftiImage:
    """In-memory NIfTI image: data array + 4x4 affine (+ raw header dict).

    The subset of nibabel's ``SpatialImage`` the package uses:
    ``get_fdata()``, ``affine``, ``shape``, ``dataobj``.  ``dataobj``
    may be a tensor on any device: the image holds a host copy.
    """

    def __init__(self, dataobj, affine=None, header=None):
        if isinstance(dataobj, torch.Tensor):
            dataobj = dataobj.detach().cpu().numpy()
        self.dataobj = np.asarray(dataobj)
        self.affine = (np.eye(4) if affine is None
                       else np.asarray(affine, dtype=np.float64))
        self.header = dict(header or {})

    @property
    def shape(self):
        return self.dataobj.shape

    def get_fdata(self):
        """Data as float64 with scl_slope/inter applied (nibabel semantics)."""
        data = self.dataobj.astype(np.float64)
        slope = self.header.get("scl_slope", 0.0)
        inter = self.header.get("scl_inter", 0.0)
        if slope not in (0.0, 1.0) and np.isfinite(slope):
            data = data * slope + inter
        elif slope == 1.0 and inter not in (0.0,) and np.isfinite(inter):
            data = data + inter
        return data


def _quaternion_to_rotation(b, c, d):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d),
         2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d,
         2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b),
         a * a + d * d - b * b - c * c],
    ])


@retry(retries=3, backoff=0.25,
       retriable=(OSError, EOFError, zlib.error), name="nifti.read")
def _read_bytes(path):
    # Shared-filesystem reads of subject images are the transient-
    # failure hot spot of long multi-subject jobs; retry with backoff.
    # A truncated .nii.gz mid-restage surfaces as EOFError or
    # zlib.error (NOT OSError subclasses; only BadGzipFile is), so
    # those are retriable too.  The faults hook lets tests inject the
    # failure deterministically.
    faults.io_point(path, site="nifti.read")
    path = str(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def load(path):
    """Load a ``.nii`` / ``.nii.gz`` file into a :class:`NiftiImage`.

    Reads retry transient failures (``OSError``, truncated-gzip
    ``EOFError``/``zlib.error``) with exponential backoff (see
    :mod:`brainiak_tpu_torch.resilience.retry`), so a momentary shared-
    filesystem hiccup does not kill an hours-long multi-subject fit.
    """
    raw = _read_bytes(path)
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{path}: too short to be a NIfTI-1 file")

    # Endianness detection via sizeof_hdr.
    for endian in ("<", ">"):
        if struct.unpack(endian + "i", raw[0:4])[0] == _HDR_SIZE:
            break
    else:
        raise ValueError(f"{path}: not a NIfTI-1 file (bad sizeof_hdr)")

    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: unsupported NIfTI magic {magic!r}")

    dim = struct.unpack(endian + "8h", raw[40:56])
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: invalid ndim {ndim}")
    shape = tuple(int(d) for d in dim[1:1 + ndim])

    datatype, = struct.unpack(endian + "h", raw[70:72])
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = _DTYPES[datatype].newbyteorder(endian)

    pixdim = struct.unpack(endian + "8f", raw[76:108])
    vox_offset, = struct.unpack(endian + "f", raw[108:112])
    scl_slope, scl_inter = struct.unpack(endian + "2f", raw[112:120])
    qform_code, sform_code = struct.unpack(endian + "2h", raw[252:256])

    if sform_code > 0:
        srow = np.frombuffer(raw[280:328], dtype=np.dtype(np.float32)
                             .newbyteorder(endian)).reshape(3, 4)
        affine = np.vstack([srow.astype(np.float64), [0, 0, 0, 1]])
    elif qform_code > 0:
        b, c, d = struct.unpack(endian + "3f", raw[256:268])
        offsets = struct.unpack(endian + "3f", raw[268:280])
        rot = _quaternion_to_rotation(b, c, d)
        qfac = -1.0 if pixdim[0] == -1.0 else 1.0
        zooms = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
        affine = np.eye(4)
        affine[:3, :3] = rot * zooms
        affine[:3, 3] = offsets
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0,
                          pixdim[3] or 1.0, 1.0])

    offset = int(vox_offset) if magic[:3] == b"n+1" else _HDR_SIZE
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=offset)
    # NIfTI stores Fortran order (x fastest).
    data = data.reshape(shape, order="F")

    header = {
        "scl_slope": float(scl_slope), "scl_inter": float(scl_inter),
        "pixdim": tuple(float(p) for p in pixdim),
        "datatype": int(datatype),
        "qform_code": int(qform_code), "sform_code": int(sform_code),
    }
    return NiftiImage(data, affine, header)


def save(img, path):
    """Save a :class:`NiftiImage` (or (data, affine)) as single-file NIfTI-1.

    Gzip-compresses when the filename ends in ``.gz``.
    """
    if not isinstance(img, NiftiImage):
        raise TypeError("save() expects a NiftiImage")
    data = np.asarray(img.dataobj)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    datatype = _DTYPE_CODES[data.dtype]
    bitpix = data.dtype.itemsize * 8
    affine = np.asarray(img.affine, dtype=np.float64)

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, datatype)
    struct.pack_into("<h", hdr, 72, bitpix)
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    pixdim = [1.0] + list(zooms) + [1.0] * 4
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    struct.pack_into("<2h", hdr, 252, 0, 2)  # qform_code=0, sform_code=2
    struct.pack_into("<4f", hdr, 280, *affine[0])
    struct.pack_into("<4f", hdr, 296, *affine[1])
    struct.pack_into("<4f", hdr, 312, *affine[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    path = str(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)

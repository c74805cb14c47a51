"""The port's file front end (``nifti``, ``io``, the condition specs
and ``MaskedMultiSubjectData`` of ``image``) against the JAX package
on the CPU.

Every file is written by the test itself (``tests/io/test_io.py``
reads fixtures from outside the repository).  Arrays come from a
numpy seed.  Tolerance: none: the two codecs are the same byte
layout, so data, affines and headers are held equal exactly, and the
error cases to the same exception types.
"""

import gzip
import importlib
import struct

import numpy as np
import pytest
import torch

from brainiak_tpu import image as jimage
from brainiak_tpu import io as jio
from brainiak_tpu import nifti as jnifti
from brainiak_tpu.resilience import faults as jfaults
from brainiak_tpu_torch import image, io, nifti
from brainiak_tpu_torch.resilience import faults
from torch_obs_state import clean_obs  # noqa: F401

retry_mod = importlib.import_module("brainiak_tpu_torch.resilience.retry")
jretry_mod = importlib.import_module("brainiak_tpu.resilience.retry")

PACKAGES = {"torch": (nifti, io, faults), "jax": (jnifti, jio, jfaults)}
AFFINE = np.array([[2.0, 0, 0, -10], [0, 2.5, 0, -20],
                   [0, 0, 3.0, 5], [0, 0, 0, 1]])


@pytest.fixture(autouse=True)
def _no_sleep(clean_obs, monkeypatch):  # noqa: F811
    monkeypatch.setattr(retry_mod, "_sleep", lambda _d: None)
    monkeypatch.setattr(jretry_mod, "_sleep", lambda _d: None)


def _volume(dtype, shape=(7, 6, 5, 4), seed=0):
    rng = np.random.RandomState(seed)
    if np.dtype(dtype).kind == "f":
        return rng.randn(*shape).astype(dtype)
    return rng.randint(-100 if np.dtype(dtype).kind == "i" else 0, 100,
                       size=shape).astype(dtype)


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16,
                                   np.uint8, np.int32])
def test_nifti_written_by_one_package_reads_in_the_other(
        tmp_path, writer, reader, suffix, dtype):
    data = _volume(dtype)
    path = tmp_path / ("img" + suffix)
    wn = PACKAGES[writer][0]
    rn = PACKAGES[reader][0]
    wn.save(wn.NiftiImage(data, AFFINE), path)
    img = rn.load(path)
    assert img.dataobj.dtype == data.dtype
    assert np.array_equal(img.dataobj, data)
    assert np.array_equal(img.affine, AFFINE)
    assert np.array_equal(img.get_fdata(), data.astype(np.float64))
    other = PACKAGES[writer][0].load(path)
    assert img.header == other.header
    # the reader's own writer gives the same bytes (the gzip stream's
    # header holds a time stamp, so the payloads are compared)
    again = tmp_path / ("again" + suffix)
    rn.save(rn.NiftiImage(data, AFFINE), again)
    assert _payload(again) == _payload(path)


def _payload(path):
    raw = path.read_bytes()
    return gzip.decompress(raw) if path.suffix == ".gz" else raw


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_scl_slope_applies_alike(tmp_path, writer, reader):
    data = np.arange(8, dtype=np.int16).reshape(2, 2, 2)
    p = tmp_path / "scaled.nii"
    wn = PACKAGES[writer][0]
    wn.save(wn.NiftiImage(data, np.eye(4)), p)
    raw = bytearray(p.read_bytes())
    raw[112:116] = struct.pack("<f", 2.5)
    raw[116:120] = struct.pack("<f", 10.0)
    p.write_bytes(raw)
    got = PACKAGES[reader][0].load(p).get_fdata()
    want = PACKAGES[writer][0].load(p).get_fdata()
    assert np.array_equal(got, want)
    assert np.array_equal(got, data * 2.5 + 10.0)


def test_qform_and_pixdim_affines_match(tmp_path):
    """A header with no sform (a quaternion qform, then none at all)
    gives the same affine in both packages."""
    good = tmp_path / "good.nii"
    nifti.save(nifti.NiftiImage(np.zeros((2, 2, 2), np.float32), AFFINE),
               good)
    raw = bytearray(good.read_bytes())
    raw[252:256] = struct.pack("<2h", 1, 0)   # qform 1, sform 0
    raw[256:268] = struct.pack("<3f", 0.1, -0.2, 0.3)
    raw[268:280] = struct.pack("<3f", 4.0, 5.0, 6.0)
    raw[76:80] = struct.pack("<f", -1.0)      # qfac
    p = tmp_path / "qform.nii"
    p.write_bytes(raw)
    q_t, q_j = nifti.load(p).affine, jnifti.load(p).affine
    assert np.array_equal(q_t, q_j) and not np.array_equal(q_t, np.eye(4))
    raw[252:256] = struct.pack("<2h", 0, 0)
    p.write_bytes(raw)
    assert np.array_equal(nifti.load(p).affine, jnifti.load(p).affine)


def test_nifti_holds_a_host_copy_of_a_tensor(tmp_path):
    data = torch.from_numpy(_volume(np.float32))
    img = nifti.NiftiImage(data, AFFINE)
    assert isinstance(img.dataobj, np.ndarray)
    io.save_as_nifti_file(data, AFFINE, tmp_path / "t.nii")
    assert np.array_equal(jnifti.load(tmp_path / "t.nii").dataobj,
                          data.numpy())


def _malformed(tmp_path):
    """(name, path, match) of the malformed files of
    ``tests/io/test_io.py``, each written here."""
    good = tmp_path / "good.nii"
    jnifti.save(jnifti.NiftiImage(np.zeros((2, 2, 2), np.float32),
                                  np.eye(4)), good)
    raw = bytearray(good.read_bytes())
    cases = []

    def write(name, payload, match):
        p = tmp_path / (name + ".nii")
        p.write_bytes(bytes(payload))
        cases.append((name, p, match))

    write("garbage", b"\x00" * 400, "sizeof_hdr")
    write("short", raw[:100], "too short")
    bad = bytearray(raw)
    bad[344:348] = b"xxx\x00"
    write("magic", bad, "magic")
    bad = bytearray(raw)
    bad[40:42] = struct.pack("<h", 0)
    write("ndim", bad, "ndim")
    bad = bytearray(raw)
    bad[70:72] = struct.pack("<h", 9999)
    write("dtype", bad, "datatype")
    return cases


def test_malformed_files_fail_alike(tmp_path):
    for name, path, match in _malformed(tmp_path):
        errors = []
        for n in (nifti, jnifti):
            with pytest.raises(ValueError, match=match) as exc:
                n.load(path)
            errors.append((type(exc.value), str(exc.value)))
        assert errors[0] == errors[1], name


def test_save_refuses_and_coerces_alike(tmp_path):
    for n in (nifti, jnifti):
        with pytest.raises(TypeError):
            n.save(np.zeros((2, 2, 2)), tmp_path / "notimg.nii")
    halves = np.zeros((2, 2, 2), dtype=np.float16)
    nifti.save(nifti.NiftiImage(halves, np.eye(4)), tmp_path / "h.nii")
    assert jnifti.load(tmp_path / "h.nii").dataobj.dtype == np.float32


def _write_subjects(tmp_path, n=3, shape=(4, 5, 3, 6)):
    rng = np.random.RandomState(3)
    vols = [rng.randn(*shape).astype(np.float32) for _ in range(n)]
    for i, v in enumerate(vols):
        io.save_as_nifti_file(v, AFFINE, tmp_path / f"s{i}_bet.nii.gz")
    mask = rng.rand(*shape[:3]) > 0.4
    io.save_as_nifti_file(mask.astype(np.uint8), AFFINE,
                          tmp_path / "mask.nii")
    specs = np.zeros((n, 2, 3, shape[3]), dtype=np.int64)
    for i in range(n):
        for e in range(3):
            specs[i, (i + e) % 2, e, 2 * e:2 * e + 2] = 1
    np.save(tmp_path / "labels.npy", specs)
    return vols, mask, specs


def test_loaders_match_jax(tmp_path):
    vols, mask, specs = _write_subjects(tmp_path)
    for suffix in ("bet.nii.gz", "nii.gz"):
        got = list(io.load_images_from_dir(tmp_path, suffix))
        want = list(jio.load_images_from_dir(str(tmp_path), suffix))
        assert len(got) == len(want) == 3
        for g, w, v in zip(got, want, vols):
            assert np.array_equal(g.get_fdata(), w.get_fdata())
            assert np.array_equal(g.dataobj, v)
    paths = [tmp_path / "s2_bet.nii.gz", str(tmp_path / "s0_bet.nii.gz")]
    got = [im.dataobj for im in io.load_images(paths)]
    assert np.array_equal(got[0], vols[2]) and \
        np.array_equal(got[1], vols[0])
    m = io.load_boolean_mask(tmp_path / "mask.nii")
    assert m.dtype == bool and np.array_equal(m, mask)
    assert np.array_equal(m, jio.load_boolean_mask(tmp_path / "mask.nii"))
    pred = io.load_boolean_mask(str(tmp_path / "mask.nii"),
                                lambda x: x > 0)
    assert np.array_equal(pred, mask)
    labels = io.load_labels(tmp_path / "labels.npy")
    jlabels = jio.load_labels(tmp_path / "labels.npy")
    assert len(labels) == 3
    for spec, jspec, raw in zip(labels, jlabels, specs):
        assert isinstance(spec, image.SingleConditionSpec)
        assert isinstance(spec, image.ConditionSpec)
        assert np.array_equal(spec, raw)
        assert np.array_equal(spec.extract_labels(),
                              jspec.extract_labels())


def test_masked_images_stack_as_in_jax(tmp_path):
    vols, mask, _ = _write_subjects(tmp_path)
    images = list(io.load_images_from_dir(tmp_path, "bet.nii.gz"))
    masked = list(image.mask_images(images, mask, np.float32))
    jmasked = list(jimage.mask_images(images, mask, np.float32))
    for g, w in zip(masked, jmasked):
        assert g.dtype == np.float32 and np.array_equal(g, w)
    got = image.MaskedMultiSubjectData.from_masked_images(iter(masked), 3)
    want = jimage.MaskedMultiSubjectData.from_masked_images(
        iter(masked), 3)
    assert isinstance(got, image.MaskedMultiSubjectData)
    assert got.shape == (6, int(mask.sum()), 3)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert np.array_equal(got[:, :, 1], masked[1].T)


@pytest.mark.parametrize("case", ["count", "shape", "empty"])
def test_masked_stack_errors_as_in_jax(case):
    rng = np.random.RandomState(1)
    masked = [rng.randn(5, 4), rng.randn(5, 4)]
    args = {"count": (masked, 3),
            "shape": ([masked[0], masked[1][:-1]], 2),
            "empty": ([], 2)}[case]
    texts = []
    for mod in (image, jimage):
        with pytest.raises(ValueError) as exc:
            mod.MaskedMultiSubjectData.from_masked_images(iter(args[0]),
                                                          args[1])
        texts.append(str(exc.value))
    assert texts[0] == texts[1]


def test_extract_labels_matches_jax():
    rng = np.random.RandomState(2)
    spec = np.zeros((3, 5, 12), dtype=np.int64)
    for e in range(5):
        spec[rng.randint(3), e, 2 * e:2 * e + 2] = 1
    got = spec.view(image.SingleConditionSpec).extract_labels()
    want = spec.view(jimage.SingleConditionSpec).extract_labels()
    assert np.array_equal(got, want) and len(got) == 5


@pytest.mark.parametrize("which", ["nifti", "labels"])
def test_injected_io_error_retried_then_raised(tmp_path, which):
    """One injected fault is retried away; a fault on every attempt
    exhausts the budget and raises, in both packages alike."""
    _write_subjects(tmp_path, n=1)
    for n, i, f in PACKAGES.values():
        load = (lambda: n.load(tmp_path / "s0_bet.nii.gz")) \
            if which == "nifti" else \
            (lambda: i.load_labels(tmp_path / "labels.npy"))
        with f.inject("io_error", times=1) as fault:
            load()
        assert fault.fired == 1
        with f.inject("io_error", times=100) as fault:
            with pytest.raises(f.InjectedIOError):
                load()
        assert fault.fired == 4

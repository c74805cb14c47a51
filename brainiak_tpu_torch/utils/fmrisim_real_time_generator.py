"""Real-time fMRI data generator, on the card.

The port's counterpart of ``brainiak_tpu/utils/fmrisim_real_time_generator
.py``: streams simulated TR-by-TR volumes, to disk or in memory, for
testing real-time analysis pipelines.  Inputs that are not provided
(ROIs, template, noise dict) are synthesized; DICOM output needs
pydicom and raises a clear error when it is absent.

The simulation (:func:`_simulate`) runs :mod:`.fmrisim` on ``device``
(default ``"cuda"``; without a card it raises unless given ``"cpu"``):
the noise and the ROI signals stay there, and the whole-scan ``brain``
[x, y, z, T] comes back to the host once, because its consumers (the
:class:`RealtimeStream` iterator, the ``.npy`` and ``.dcm`` writers)
are on the host.  Two modes share it:

- :func:`generate_data` writes mask/labels/ROI volumes plus one
  ``rt_<TR>.npy`` (or ``.dcm``) per TR, optionally paced at one volume
  per ``trDuration`` (``save_realtime``).
- :func:`generate_stream` returns a :class:`RealtimeStream` whose
  iterator yields one ``[x, y, z]`` volume per TR, paced by
  :class:`~brainiak_tpu_torch.utils.utils.MonotonicPacer` when asked.

Randomness: ``rng`` accepts a seed or a ``numpy.random.Generator`` and
threads through this module's own draws; since :mod:`.fmrisim` draws on
the host from NumPy's global stream, a seeded call pins that stream
from the generator for the duration of the simulation and restores it
afterwards, so the whole volume sequence is reproducible, and equal to
the JAX package's under the same seed.  ``rng=None`` draws from the
global state.

Run as ``python -m brainiak_tpu_torch.utils.fmrisim_real_time_generator
-o DIR``.
"""

import argparse
import ast
import logging
import os
import time
from pathlib import Path

import numpy as np

from ..device import resolve_device
from . import fmrisim as sim

logger = logging.getLogger(__name__)

__all__ = ["RealtimeStream", "default_settings", "generate_data",
           "generate_stream"]

default_settings = {
    'ROI_A_file': None,
    'ROI_B_file': None,
    'template_path': None,
    'noise_dict_file': None,
    'numTRs': 200,
    'event_duration': 10,
    'scale_percentage': 0.5,
    'multivariate_pattern': False,
    'different_ROIs': False,
    'save_dicom': False,
    'save_realtime': False,
    'trDuration': 2,
    'isi': 6,
    'burn_in': 6,
}


class _GlobalStateRNG:
    """Draw source for ``rng=None``: this module's own draws come from
    NumPy's global state (``np.random.randint`` / ``rand``)."""

    @staticmethod
    def integers(low, high):
        return np.random.randint(low, high)

    @staticmethod
    def random(shape):
        return np.random.rand(*shape)


def _resolve_rng(rng):
    """``(generator, seeded)``: the draw source for this module's own
    draws, and whether the caller asked for determinism (a seed or a
    Generator), in which case the global NumPy stream that fmrisim
    draws from is pinned too, and restored afterwards."""
    if rng is None:
        return _GlobalStateRNG(), False
    return np.random.default_rng(rng), True


def _default_inputs(data_dict, dev):
    """The template, ROIs and noise parameters: loaded from the files
    the settings name, else synthesized (the packaged template on a
    24 x 24 x 16 grid, two 4-voxel cubes)."""
    dims = np.array([24, 24, 16])
    if data_dict['template_path'] is None:
        _, template = sim.mask_brain(dims, mask_self=False, device=dev)
        template = template * 1000
    else:
        template = np.load(data_dict['template_path'])
        dims = np.array(template.shape[:3])

    def roi(path, center):
        if path:
            return sim._as64(np.load(path), dev)
        return sim.generate_signal(dimensions=dims,
                                   feature_coordinates=np.array([center]),
                                   feature_type=['cube'],
                                   feature_size=[4],
                                   signal_magnitude=[1], device=dev)

    roi_a = roi(data_dict['ROI_A_file'], [8, 8, 8])
    roi_b = roi(data_dict['ROI_B_file'], [16, 16, 8])

    if data_dict['noise_dict_file']:
        with open(data_dict['noise_dict_file']) as f:
            noise_dict = ast.literal_eval(f.read())
    else:
        noise_dict = {'snr': 30, 'sfnr': 70, 'max_activity': 1000,
                      'matched': 0}
    return roi_a, roi_b, template, noise_dict, dims


def _save_volume(volume, out_file, save_dicom):
    if save_dicom:
        try:
            import pydicom  # noqa: F401
        except ImportError:
            raise ImportError(
                "DICOM output requires pydicom, which is not installed; "
                "use save_dicom=False for .npy output")
        _write_dicom(volume, out_file)
    else:
        np.save(out_file, volume.astype(np.int16))


def _write_dicom(volume, out_file):
    """Minimal secondary-capture DICOM writer."""
    import pydicom
    from pydicom.dataset import FileDataset, FileMetaDataset

    meta = FileMetaDataset()
    meta.MediaStorageSOPClassUID = \
        pydicom.uid.SecondaryCaptureImageStorage
    meta.MediaStorageSOPInstanceUID = pydicom.uid.generate_uid()
    meta.TransferSyntaxUID = pydicom.uid.ImplicitVRLittleEndian
    ds = FileDataset(out_file, {}, file_meta=meta, preamble=b"\0" * 128)
    ds.NumberOfFrames = volume.shape[2]
    ds.Rows = volume.shape[0]
    ds.Columns = volume.shape[1]
    ds.SamplesPerPixel = 1
    ds.BitsAllocated = 16
    ds.BitsStored = 16
    ds.HighBit = 15
    ds.PixelRepresentation = 0
    ds.PhotometricInterpretation = "MONOCHROME2"
    ds.PixelData = volume.astype(np.uint16).tobytes()
    ds.save_as(out_file, write_like_original=False)


def _simulate(data_dict, rng, device="cuda"):
    """The simulation shared by the on-disk and in-memory modes: a dict
    of host arrays ``brain`` [x, y, z, T], ``mask``, ``roi_a``,
    ``roi_b`` (binary uint8 volumes), ``labels`` [T*tr, 1] and
    ``dims``.  ``rng`` is this module's draw stream (onset coin flips,
    the multivariate pattern); when the caller seeded it, the global
    NumPy stream is pinned from it for the simulation."""
    dev = resolve_device(device)
    rng, seeded = _resolve_rng(rng)
    if not seeded:
        return _simulate_body(data_dict, rng, dev)
    saved_state = np.random.get_state()
    np.random.seed(int(rng.integers(0, 2 ** 32)))
    try:
        return _simulate_body(data_dict, rng, dev)
    finally:
        np.random.set_state(saved_state)


def _simulate_body(data_dict, rng, dev):
    roi_a, roi_b, template, noise_dict, dims = _default_inputs(data_dict,
                                                               dev)
    mask, template = sim.mask_brain(volume=template, mask_self=True,
                                    device=dev)

    noise_dict['matched'] = 0
    num_trs = data_dict['numTRs']
    tr_dur = data_dict['trDuration']
    logger.info('Generating noise')
    noise = sim.generate_noise(
        dimensions=dims,
        stimfunction_tr=np.zeros((num_trs, 1)),
        tr_duration=int(tr_dur),
        template=template,
        mask=mask,
        noise_dict=noise_dict, device=dev)

    total_time = int(num_trs * tr_dur)
    onsets_a, onsets_b = [], []
    curr_time = data_dict['burn_in']
    while curr_time < total_time - data_dict['event_duration']:
        (onsets_a if int(rng.integers(0, 2)) == 1
         else onsets_b).append(curr_time)
        curr_time += data_dict['event_duration'] + data_dict['isi']

    temporal_res = 1 / tr_dur
    stimfunc_a = sim.generate_stimfunction(
        onsets=onsets_a, event_durations=[data_dict['event_duration']],
        total_time=total_time, temporal_resolution=temporal_res)
    stimfunc_b = sim.generate_stimfunction(
        onsets=onsets_b, event_durations=[data_dict['event_duration']],
        total_time=total_time, temporal_resolution=temporal_res)
    labels = stimfunc_a + stimfunc_b * 2

    def roi_signal(roi_vol, stimfunc, scale):
        """Evoked signal within an ROI scaled as percent signal change."""
        sf = sim.convolve_hrf(stimfunc, tr_dur,
                              temporal_resolution=temporal_res, device=dev)
        inside = roi_vol > 0
        n_vox = int(inside.sum())
        if data_dict['multivariate_pattern']:
            sf = sf @ sim._upload(rng.random((1, n_vox)), dev)
        sig_func = sf.expand(-1, n_vox) if sf.shape[1] == 1 else sf
        sig_func = sim.compute_signal_change(
            sig_func, noise[inside].T, noise_dict, [scale], 'PSC',
            device=dev)
        return sim.apply_signal(sig_func, roi_vol, device=dev)

    scale = data_dict['scale_percentage']
    signal_a = roi_signal(roi_a, stimfunc_a, scale)
    if data_dict['different_ROIs']:
        signal_b = roi_signal(roi_b, stimfunc_b, scale)
    elif data_dict['multivariate_pattern']:
        signal_b = roi_signal(roi_a, stimfunc_b, scale)
    else:
        signal_b = roi_signal(roi_a, stimfunc_b, scale * 0.5)

    brain = noise + signal_a + signal_b
    return {
        'brain': brain.cpu().numpy(),
        'mask': mask.cpu().numpy().astype(np.uint8),
        'roi_a': (roi_a > 0).cpu().numpy().astype(np.uint8),
        'roi_b': (roi_b > 0).cpu().numpy().astype(np.uint8),
        'labels': labels,
        'dims': dims,
    }


class RealtimeStream:
    """In-memory realtime scan: iterate for one ``[x, y, z]`` volume
    per TR (host arrays, no disk round-trip).

    Attributes mirror the files :func:`generate_data` writes:
    ``mask`` / ``roi_a`` / ``roi_b`` (binary uint8 volumes),
    ``labels`` (per-stimulus-sample condition vector), ``n_trs``,
    ``tr_duration_s``, plus the full ``brain`` [x, y, z, T] array.
    ``paced=True`` delivers TR ``t`` at ``start + t * trDuration`` (the
    ``save_realtime`` analog); the default yields as fast as the
    consumer pulls.
    """

    def __init__(self, sim_out, tr_duration_s, paced=False):
        self.brain = sim_out['brain']
        self.mask = sim_out['mask']
        self.roi_a = sim_out['roi_a']
        self.roi_b = sim_out['roi_b']
        self.labels = sim_out['labels']
        self.tr_duration_s = float(tr_duration_s)
        self.paced = bool(paced)

    @property
    def n_trs(self):
        return int(self.brain.shape[3])

    def __len__(self):
        return self.n_trs

    def volume(self, tr):
        """The ``[x, y, z]`` volume at ``tr`` (random access)."""
        return self.brain[:, :, :, int(tr)]

    def __iter__(self):
        from .utils import MonotonicPacer

        pacer = MonotonicPacer(self.tr_duration_s
                               if self.paced else 0.0)
        for tr in range(self.n_trs):
            pacer.wait()
            yield self.brain[:, :, :, tr]


def generate_stream(user_settings=None, rng=None, paced=False,
                    device="cuda"):
    """Simulate a realtime scan in memory on ``device``; returns a
    :class:`RealtimeStream` of host volumes (the same volumes the
    on-disk path writes, before the int16 save cast).

    ``user_settings`` updates :data:`default_settings`; ``rng`` is a
    seed or ``numpy.random.Generator``.
    """
    data_dict = default_settings.copy()
    data_dict.update(user_settings or {})
    out = _simulate(data_dict, rng, device)
    return RealtimeStream(out, data_dict['trDuration'], paced=paced)


def generate_data(outputDir, user_settings, rng=None, device="cuda"):
    """Simulate on ``device`` and write the realtime data to
    ``outputDir``: mask.npy, roi_a.npy, roi_b.npy, labels.npy, and one
    rt_<TR>.npy (or .dcm) per TR.  A fixed ``rng`` seed makes the
    written bytes deterministic across runs on one device."""
    data_dict = default_settings.copy()
    data_dict.update(user_settings)
    Path(outputDir).mkdir(parents=True, exist_ok=True)

    out = _simulate(data_dict, rng, device)
    np.save(os.path.join(outputDir, 'mask.npy'), out['mask'])
    np.save(os.path.join(outputDir, 'roi_a.npy'), out['roi_a'])
    np.save(os.path.join(outputDir, 'roi_b.npy'), out['roi_b'])
    np.save(os.path.join(outputDir, 'labels.npy'), out['labels'])

    num_trs = data_dict['numTRs']
    tr_dur = data_dict['trDuration']
    brain = out['brain']
    for tr in range(num_trs):
        start = time.time()
        vol = brain[:, :, :, tr]
        ext = 'dcm' if data_dict['save_dicom'] else 'npy'
        out_file = os.path.join(outputDir, 'rt_{0:0>3}.{1}'.format(tr, ext))
        _save_volume(vol, out_file, data_dict['save_dicom'])
        if data_dict['save_realtime']:
            elapsed = time.time() - start
            time.sleep(max(0.0, tr_dur - elapsed))
    logger.info('Generated %d volumes in %s', num_trs, outputDir)


def main():
    p = argparse.ArgumentParser(description="Generate simulated realtime "
                                            "fMRI data")
    p.add_argument('--output-dir', '-o', required=True, type=str)
    p.add_argument('--ROI-A-file', default=None, type=str)
    p.add_argument('--ROI-B-file', default=None, type=str)
    p.add_argument('--template-path', default=None, type=str)
    p.add_argument('--noise-dict-file', default=None, type=str)
    p.add_argument('--numTRs', '-n', default=200, type=int)
    p.add_argument('--event-duration', '-d', default=10, type=int)
    p.add_argument('--trDuration', default=2, type=int)
    p.add_argument('--isi', default=6, type=int)
    p.add_argument('--burn-in', default=6, type=int)
    p.add_argument('--scale-percentage', '-s', default=0.5, type=float)
    p.add_argument('--multivariate-pattern', '-m', action='store_true')
    p.add_argument('--different-ROIs', '-r', action='store_true')
    p.add_argument('--save-dicom', action='store_true')
    p.add_argument('--save-realtime', action='store_true')
    p.add_argument('--seed', default=None, type=int,
                   help="seed the simulation (deterministic output "
                        "bytes for a fixed seed)")
    p.add_argument('--device', default="cuda", type=str,
                   help="torch device of the simulation (default cuda)")
    args = p.parse_args()
    settings = {
        'ROI_A_file': args.ROI_A_file,
        'ROI_B_file': args.ROI_B_file,
        'template_path': args.template_path,
        'noise_dict_file': args.noise_dict_file,
        'numTRs': args.numTRs,
        'event_duration': args.event_duration,
        'trDuration': args.trDuration,
        'isi': args.isi,
        'burn_in': args.burn_in,
        'scale_percentage': args.scale_percentage,
        'multivariate_pattern': args.multivariate_pattern,
        'different_ROIs': args.different_ROIs,
        'save_dicom': args.save_dicom,
        'save_realtime': args.save_realtime,
    }
    generate_data(args.output_dir, settings, rng=args.seed,
                  device=args.device)


if __name__ == "__main__":
    main()

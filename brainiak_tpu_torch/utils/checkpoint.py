"""Checkpoint / resume for the port's iterative fits (npz files).

The npz writer of ``brainiak_tpu.utils.checkpoint``: a flat dict of
arrays is saved every k iterations as ``<directory>/ckpt_<step>.npz``
(written to a temporary name, then renamed atomically), the latest
step is found from the file names, and only the ``max_to_keep``
newest files stay.  The JAX package writes the same files when it
takes its npz path (``BRAINIAK_TPU_CHECKPOINT_NPZ=1``, or no orbax), so
a checkpoint either package writes, the other restores.  The port
neither writes nor reads the JAX package's orbax checkpoints (orbax is
a JAX library).
"""

import logging
import os

import numpy as np

from ..resilience import faults
from ..resilience.retry import retry

logger = logging.getLogger(__name__)

__all__ = ["CheckpointManager"]


class CheckpointManager:
    """Manager of (step, flat dict of arrays) checkpoints in npz files.

    ``save`` and ``restore`` retry transient ``OSError`` with
    exponential backoff (:func:`brainiak_tpu_torch.resilience.retry
    .retry`) — a checkpoint writer on a shared filesystem must survive
    the transient faults it exists to protect against.
    """

    def __init__(self, directory, max_to_keep=2):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    @retry(retries=2, backoff=0.2, retriable=(OSError,),
           name="checkpoint.save")
    def save(self, step, state):
        """Persist ``state`` (a flat dict of arrays) at ``step``."""
        faults.io_point(self.directory, site="checkpoint.save")
        path = os.path.join(self.directory, f"ckpt_{step}.npz")
        # savez appends ".npz" to bare filenames, so write through an
        # open handle to keep the tmp name exact for the atomic rename.
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in state.items()})
        os.replace(tmp, path)  # atomic: survive preemption mid-save
        self._prune()

    def _prune(self):
        # None or <=0 mean keep everything
        if not self.max_to_keep or self.max_to_keep <= 0:
            return
        for s in self._steps()[:-self.max_to_keep]:
            try:
                os.remove(os.path.join(self.directory, f"ckpt_{s}.npz"))
            except OSError:  # pragma: no cover - concurrent cleanup
                pass

    @staticmethod
    def _npz_step(fname):
        if fname.startswith("ckpt_") and fname.endswith(".npz"):
            try:
                return int(fname[5:-4])
            except ValueError:
                return None
        return None

    def _steps(self):
        return sorted(s for s in (self._npz_step(f)
                                  for f in os.listdir(self.directory))
                      if s is not None)

    def latest_step(self):
        steps = self._steps()
        return steps[-1] if steps else None

    @retry(retries=2, backoff=0.2, retriable=(OSError,),
           name="checkpoint.restore")
    def restore(self, step=None):
        """Load the checkpoint at ``step`` (default latest); returns
        (step, state) or (None, None) when nothing exists."""
        faults.io_point(self.directory, site="checkpoint.restore")
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.directory, f"ckpt_{step}.npz")
        with np.load(path) as loaded:
            return step, {k: loaded[k] for k in loaded.files}

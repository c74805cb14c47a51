"""Activity-based (MVPA) voxel selection by searchlight, the port's.

PyTorch-package counterpart of ``brainiak_tpu/fcma/mvpa_voxelselector.py``:
each voxel is scored by the cross-validated accuracy of a classifier
on the activity of its searchlight neighbourhood, on the host tier of
:class:`~brainiak_tpu_torch.searchlight.Searchlight`.  The JAX package
folds with sklearn's ``StratifiedKFold`` and scores with
``cross_val_score``; the port imports no sklearn, so the folds come
from :func:`~brainiak_tpu_torch.ops.svm.stratified_kfold` (the same
folds) and each fold fits a fresh copy (``copy.deepcopy``) of the
estimator passed in and scores it with its ``score(test_x, test_y)``,
which is what ``cross_val_score``'s default scorer calls.  The
estimator is any object with ``fit`` and ``score`` (an sklearn
classifier, or one written in torch).
"""

import copy
import logging

import numpy as np

from ..ops.svm import stratified_kfold

logger = logging.getLogger(__name__)

__all__ = ["MVPAVoxelSelector"]


def _sfn(data, mask, myrad, bcast_var):
    """Searchlight voxel function: the mean cross-validated accuracy of
    the masked activity vectors."""
    labels, num_folds, clf = bcast_var[0], bcast_var[1], bcast_var[2]
    labels = np.asarray(labels)
    masked_data = data[0][mask, :].T
    scores = []
    for train, test in stratified_kfold(labels, num_folds):
        model = copy.deepcopy(clf)
        model.fit(masked_data[train], labels[train])
        scores.append(model.score(masked_data[test], labels[test]))
    return np.mean(scores)


class MVPAVoxelSelector:
    """Searchlight cross-validated accuracy voxel ranking.

    Parameters
    ----------
    data : 4D array [x, y, z, epoch] (from
        :func:`~brainiak_tpu_torch.fcma.preprocessing
        .prepare_searchlight_mvpa_data`)
    mask : 3D boolean array
    labels : per-epoch condition labels
    num_folds : cross-validation folds
    sl : a :class:`~brainiak_tpu_torch.searchlight.Searchlight`; its
        host tier runs the folds (serially, or in its process pool:
        see its ``pool_size``)
    """

    def __init__(self, data, mask, labels, num_folds, sl):
        self.data = data
        self.mask = mask.astype(bool)
        self.labels = labels
        self.num_folds = num_folds
        self.sl = sl
        if np.sum(self.mask) == 0:
            raise ValueError('Zero processed voxels')

    def run(self, clf):
        """Returns ``(result_volume, [(voxel_id, accuracy)])``, the list
        sorted by accuracy, highest first (a skipped voxel counts 0);
        ``voxel_id`` indexes the mask's voxels in C order."""
        logger.info('running activity-based voxel selection via '
                    'Searchlight')
        self.sl.distribute([self.data], self.mask)
        self.sl.broadcast((self.labels, self.num_folds, clf))
        result_volume = self.sl.run_searchlight(_sfn)
        result_list = result_volume[self.mask]
        results = []
        for idx, value in enumerate(result_list):
            if value is None:
                value = 0
            results.append((idx, value))
        results.sort(key=lambda tup: tup[1], reverse=True)
        return result_volume, results

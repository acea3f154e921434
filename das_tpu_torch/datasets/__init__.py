from .base import BasePoseDataset, ConcatDataset, RepeatDataset
from .builder import build_dataset
from .coco_index import CocoIndex
from .coco_kpts import COCOKeypointsDataset
from .muco import MuCo3DHPDataset
from .mupots import MuPots3DHP
from .panoptic import CMUPanopticDataset
from . import pipelines  # noqa: F401  (registers transforms)

__all__ = [
    'BasePoseDataset', 'ConcatDataset', 'RepeatDataset', 'build_dataset',
    'CocoIndex', 'CMUPanopticDataset', 'COCOKeypointsDataset',
    'MuCo3DHPDataset', 'MuPots3DHP'
]

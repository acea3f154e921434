from .das_head import DASHead
from .detector import DAS, build_model
from .fpn import FPN
from .layers import ConvModule, DeformConv2d, Scale
from .mspn import MSPN2
from .real_nvp import RealNVP
from .recursive_update import RecursiveUpdateBranch

__all__ = [
    'DAS', 'DASHead', 'FPN', 'MSPN2', 'RealNVP', 'RecursiveUpdateBranch',
    'ConvModule', 'DeformConv2d', 'Scale', 'build_model'
]

from .das_head import DASHead
from .detector import DAS, build_model, build_trainable_model
from .fpn import FPN
from .hrnet import HRNet
from .layers import ConvModule, DeformConv2d, Scale
from .mspn import MSPN2
from .real_nvp import RealNVP
from .recursive_update import RecursiveUpdateBranch
from .swin import SwinTransformer

__all__ = [
    'DAS', 'DASHead', 'FPN', 'HRNet', 'MSPN2', 'RealNVP',
    'RecursiveUpdateBranch', 'SwinTransformer', 'ConvModule',
    'DeformConv2d', 'Scale',
    'build_model', 'build_trainable_model'
]

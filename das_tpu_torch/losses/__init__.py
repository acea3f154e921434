"""Training losses of the DAS head, in f32."""

from .common import binary_cross_entropy, sigmoid_focal_loss, smooth_l1_loss
from .rle_loss import rle_loss

__all__ = ['binary_cross_entropy', 'rle_loss', 'sigmoid_focal_loss',
           'smooth_l1_loss']

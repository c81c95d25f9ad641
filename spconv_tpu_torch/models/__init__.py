from .classifier import SparseClassifier
from .second import (SparseBasicBlock, SparseEncoder, centerpoint_encoder,
                     second_encoder)
from .unet import SparseUNet

__all__ = [
    "SparseBasicBlock",
    "SparseEncoder",
    "second_encoder",
    "centerpoint_encoder",
    "SparseUNet",
    "SparseClassifier",
]

from .second import (SparseBasicBlock, SparseEncoder, centerpoint_encoder,
                     second_encoder)

__all__ = [
    "SparseBasicBlock",
    "SparseEncoder",
    "second_encoder",
    "centerpoint_encoder",
]

from . import coords, dg_conv, epilogue, pool, rulebook
from .dg_conv import (build_dg_pos, build_dg_pos_affine,
                      build_dg_pos_divide, dg_fwd, dg_regular_conv,
                      dg_subm_conv)
from .pool import pool2_seg
from .rulebook import build_conv_outputs

__all__ = ["coords", "dg_conv", "epilogue", "pool", "rulebook",
           "build_dg_pos", "build_dg_pos_affine", "build_dg_pos_divide",
           "dg_fwd", "dg_subm_conv",
           "dg_regular_conv", "build_conv_outputs", "pool2_seg"]

from . import coords, dg_conv, epilogue, pool
from .dg_conv import build_dg_pos, dg_fwd, dg_subm_conv
from .pool import pool2_seg

__all__ = ["coords", "dg_conv", "epilogue", "pool", "build_dg_pos",
           "dg_fwd", "dg_subm_conv", "pool2_seg"]

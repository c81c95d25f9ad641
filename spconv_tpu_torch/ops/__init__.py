from . import (coords, dg_conv, epilogue, pool, probes, rulebook,
               sorted_pool)
from .dg_conv import (build_dg_pos, build_dg_pos_affine,
                      build_dg_pos_divide, dg_fwd, dg_regular_conv,
                      dg_subm_conv)
from .pool import global_pool, pool2_seg
from .rulebook import (build_conv_outputs, build_deconv_outputs,
                       build_pool2_outputs)
from .sorted_pool import sk_pool2

__all__ = ["coords", "dg_conv", "epilogue", "pool", "probes", "rulebook",
           "sorted_pool", "build_dg_pos", "build_dg_pos_affine",
           "build_dg_pos_divide", "dg_fwd", "dg_subm_conv",
           "dg_regular_conv", "build_conv_outputs", "build_deconv_outputs",
           "build_pool2_outputs", "pool2_seg", "global_pool", "sk_pool2"]

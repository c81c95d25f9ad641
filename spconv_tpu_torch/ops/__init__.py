from . import (coords, dg_conv, epilogue, gather_gemm, point2voxel, pool,
               probes, rulebook, sorted_pool)
from .coords import (delinearize, get_conv_output_size,
                     get_deconv_output_size, kernel_offsets, linearize)
from .dg_conv import (build_dg_pos, build_dg_pos_affine,
                      build_dg_pos_divide, dg_fwd, dg_regular_conv,
                      dg_subm_conv)
from .gather_gemm import (dgrad_gather_mm, gather_mm, indice_conv,
                          wgrad_gather_mm)
from .point2voxel import gather_features_by_pc_voxel_id, point_to_voxel
from .pool import global_pool, indice_avgpool, indice_maxpool, pool2_seg
from .rulebook import (build_conv_outputs, build_conv_rulebook,
                       build_deconv_outputs, build_pool2_outputs,
                       build_pool2_rulebook, build_subm_rulebook,
                       get_indice_pairs)
from .sorted_pool import sk_pool2

__all__ = ["coords", "dg_conv", "epilogue", "gather_gemm", "point2voxel",
           "pool", "probes", "rulebook", "sorted_pool", "get_conv_output_size",
           "get_deconv_output_size", "kernel_offsets", "linearize",
           "delinearize", "build_dg_pos", "build_dg_pos_affine",
           "build_dg_pos_divide", "dg_fwd", "dg_subm_conv",
           "dg_regular_conv", "build_conv_outputs", "build_deconv_outputs",
           "build_pool2_outputs", "build_subm_rulebook",
           "build_conv_rulebook", "build_pool2_rulebook", "get_indice_pairs",
           "indice_conv", "gather_mm", "dgrad_gather_mm", "wgrad_gather_mm",
           "indice_maxpool", "indice_avgpool", "pool2_seg", "global_pool",
           "sk_pool2", "point_to_voxel", "gather_features_by_pc_voxel_id"]

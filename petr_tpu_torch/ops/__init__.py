"""The port's numeric ops and its kernels' wrappers. Importing the package
registers every kernel's ``torch.library`` op (``petr_tpu_torch::*``: K1's,
K4's, K5's and K6's forwards), which is all that an exported serving
artifact needs besides PyTorch (``petr_tpu_torch.runtime``)."""

from petr_tpu_torch.ops import conv3x3, conv_int8, dcn  # noqa: F401  (registers the ops)
from petr_tpu_torch.ops.boxes import box_corners, decode_bbox, encode_bbox
from petr_tpu_torch.ops.cross_attention import (
    flash_cross_attention,
    flash_cross_attention_backward_reference,
    flash_cross_attention_reference,
    flash_cross_attention_with_lse,
)
from petr_tpu_torch.ops.geometry import (
    backproject_frustum,
    depth_bins,
    frustum_coords,
    inverse_sigmoid,
    pos2posemb3d,
    position_coords_3d,
    sine_posemb_2d_multiview,
)
from petr_tpu_torch.ops.losses import (
    bbox_l1_cost,
    focal_loss_cost,
    sigmoid_focal_loss,
    weighted_l1_loss,
)
from petr_tpu_torch.ops.matcher import hungarian_match, lap_solve
from petr_tpu_torch.ops.nms_free import nms_free_decode

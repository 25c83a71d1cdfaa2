from petr_tpu_torch.ops.boxes import decode_bbox, encode_bbox
from petr_tpu_torch.ops.cross_attention import (
    flash_cross_attention,
    flash_cross_attention_reference,
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
from petr_tpu_torch.ops.nms_free import nms_free_decode

from petr_tpu_torch.serve.export import build_detector, decode_last_layer, make_serving_fn, resolve_device, serving_input_spec
from petr_tpu_torch.serve.server import InferenceServer
from petr_tpu_torch.serve.streaming import (
    StreamingPETRv2,
    align_prev_lidar2img,
    lidar2global,
    self_padded_timestamp,
)

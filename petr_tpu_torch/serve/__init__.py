from petr_tpu_torch.serve.export import (
    StreamingArtifactRunner,
    build_detector,
    decode_last_layer,
    export_serving,
    export_streaming,
    load_artifact,
    make_serving_fn,
    make_streaming_fns,
    resolve_device,
    save_artifact,
    save_streaming_artifact,
    serving_input_spec,
    streaming_input_spec,
)
from petr_tpu_torch.serve.server import InferenceServer
from petr_tpu_torch.serve.streaming import (
    StreamingPETRv2,
    align_prev_lidar2img,
    lidar2global,
    self_padded_timestamp,
)

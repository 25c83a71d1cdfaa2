"""Host-side data: synthetic scenes, info records, IDA transforms, the loader."""
from petr_tpu_torch.data.transforms import (
    sample_ida_params,
    apply_ida,
    compose_lidar2img,
    bev_rotate_scale,
    normalize_image,
    pad_image,
)
from petr_tpu_torch.data.dataset import NuScenesDataset, Loader, collate_batch
from petr_tpu_torch.data.synthetic import generate_synthetic_scenes

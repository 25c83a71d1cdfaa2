"""nuScenes detection metrics and the submission export (numpy only)."""
from petr_tpu_torch.metrics.nuscenes import evaluate_detections, DetectionBox

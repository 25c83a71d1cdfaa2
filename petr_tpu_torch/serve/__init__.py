from petr_tpu_torch.serve.export import build_detector, make_serving_fn, resolve_device
from petr_tpu_torch.serve.server import InferenceServer

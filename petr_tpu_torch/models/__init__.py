from petr_tpu_torch.models.depth_encoder import DepthGTEncoder, bin_depth_indices, gt_depth_maps, lid_bin_values
from petr_tpu_torch.models.depthr_head import DepthrDecoderLayer, DepthrHead
from petr_tpu_torch.models.detector import PETRDetector, TrainNoise, draw_train_noise, init_weights
from petr_tpu_torch.models.fpn import CPFPN
from petr_tpu_torch.models.grid_mask import FloatGridParams, GridParams, exact_mask, grid_mask
from petr_tpu_torch.models.petr_head import PETRHead
from petr_tpu_torch.models.positional import LearnedPositionalEncoding3D
from petr_tpu_torch.models.petrv2_head import PETRv2Head, RegLayer
from petr_tpu_torch.models.transformer import PETRTransformer, PETRTransformerDecoder
from petr_tpu_torch.models.vovnet import VoVNet

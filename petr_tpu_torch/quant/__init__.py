"""Post-training int8 quantisation (PTQ) of the VoVNet backbone for serving.

Counterpart of `petr_tpu/quant`: a calibration pass records each quantised
conv's input range, and the int8 forward runs those convs on int8 operands
with int32 sums (``ops.conv_int8``, K6 on the card):

    from petr_tpu_torch.quant import calibrate_detector, save_scales, load_scales, apply_scales

    scales = calibrate_detector(cfg, model, batches)   # the "calib" pass
    apply_scales(model, scales)                        # the int8 backbone

Scales are petr_tpu's "quant" tree (``{"backbone": {"stem1": {"act_amax":
...}, ...}}``) and its ``.npz`` keys, so one scales file serves both
packages; the model's ``state_dict`` and checkpoints are untouched.
"""

from petr_tpu_torch.quant.ptq import (
    apply_scales,
    calibrate,
    calibrate_detector,
    load_scales,
    quant_convs,
    save_scales,
    scales_of,
    set_quant,
)

__all__ = ["apply_scales", "calibrate", "calibrate_detector", "load_scales", "quant_convs", "save_scales",
           "scales_of", "set_quant"]

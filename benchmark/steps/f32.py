"""The float32 serving step of ``predict --f32`` / ``serve --f32`` (TF32
off): ``inference.make_sr_step`` over ``InferenceModelB2``."""

import torch


def build(cfg, stats, variables, calib, dev):
    """(step, step_params) for ``inference.predict_granule``."""
    from sifsr_tpu_torch.inference import make_sr_step
    from sifsr_tpu_torch.models.fused import InferenceModelB2
    step = make_sr_step(stats, torch.float32, dev, None)
    return step, InferenceModelB2.from_variables(variables).to(dev, torch.float32)

"""The int8 ``prow`` serving step of ``predict --pallas`` / ``serve
--pallas``, built as ``cli.serve`` builds it: calibrated once on the
set-up granule ``calib`` (lst, ndvi)."""


def build(cfg, stats, variables, calib, dev):
    """(step, step_params) for ``inference.predict_granule``."""
    from sifsr_tpu_torch.cli.predict import make_quantized_step
    return make_quantized_step(variables, calib[0], calib[1], stats, True, device=dev)

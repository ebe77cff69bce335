"""Training objectives for the three published recipes."""

from sifsr_tpu_torch.losses.losses import (
    ds_loss,
    huber,
    percep_loss_gradftm,
    percep_loss_predef,
    scale_invariance_loss,
    sif_loss_gradftm,
    sif_loss_predef,
)

__all__ = ["huber", "ds_loss", "percep_loss_predef", "percep_loss_gradftm",
           "sif_loss_predef", "sif_loss_gradftm", "scale_invariance_loss"]

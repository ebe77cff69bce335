"""Training: train/eval steps, Adam, early stopping, epoch checkpoints."""

from sifsr_tpu_torch.train.early_stopping import EarlyStopping
from sifsr_tpu_torch.train.loop import train_loop
from sifsr_tpu_torch.train.state import SifTrainState, create_train_state
from sifsr_tpu_torch.train.step import make_eval_step, make_train_step

__all__ = ["SifTrainState", "create_train_state", "make_train_step", "make_eval_step",
           "EarlyStopping", "train_loop"]

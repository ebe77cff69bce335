"""Early stopping with best-state capture: reference utils.model_checkpoint
(utils.py:667-714) semantics, as a small host-side object.

Behavioural parity details:
- improvement means the monitored value is STRICTLY lower than the best;
  a tie counts against patience (reference uses ``>=`` at utils.py:688);
- the first epoch always captures state but does NOT reset patience counters
  (it runs the ``curr_epoch == 1`` branch);
- training stops when curr_patience >= patience, or when max epochs is hit
  with a nonzero patience counter.

A model's ``state_dict()`` holds live tensors that Adam and BatchNorm go on
updating in place, so the snapshot copies every tensor to host memory: without
the copy the "best" weights would silently become the last ones.
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["EarlyStopping", "snapshot"]


def snapshot(state: Any) -> Any:
    """A copy of a (nested) dict of tensors on the host, detached from the
    tensors it was taken from; other leaves are kept as they are."""
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().clone()
    if isinstance(state, dict):
        return type(state)((k, snapshot(v)) for k, v in state.items())
    return state


class EarlyStopping:
    def __init__(self, n_epochs: int, patience: int = 5):
        self.patience = patience
        self.curr_patience = 0
        self.saved_state: Any = None
        self.saved_best_value: float | None = None
        self.best_epoch: int | None = None
        self.max_epochs = n_epochs
        self.should_stop = False

    def update(self, epoch: int, value: float, state: Any) -> None:
        """Record epoch ``epoch`` (1-based) with monitored ``value``; snapshot
        ``state`` (a dict of tensors, copied to the host) if best."""
        if epoch == 1:
            self.best_epoch = epoch
            self.saved_state = snapshot(state)
            self.saved_best_value = value
            return
        if value >= self.saved_best_value:
            self.curr_patience += 1
            if self.curr_patience >= self.patience:
                self.should_stop = True
            elif self.curr_patience > 0 and epoch == self.max_epochs:
                self.should_stop = True
        else:
            self.best_epoch = epoch
            self.curr_patience = 0
            self.saved_best_value = value
            self.saved_state = snapshot(state)

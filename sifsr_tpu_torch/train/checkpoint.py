"""Epoch checkpoints with mid-training resume, and the final experiment files.

Port of ``sifsr_tpu/train/checkpoint.py`` over ``torch.save``/``torch.load``
(the JAX package uses orbax and flax msgpack, which a machine with only
PyTorch does not have). Every epoch persists {model, optimiser, step,
early-stopping state and metrics, best-so-far snapshot}, and training resumes
from the latest one; the reference keeps the best state dict in memory and
writes once at the very end (utils.py:667-714, 802-826), so a crash loses the
whole run.

The epoch checkpoints of the two packages are not interchangeable. The final
weights are: ``save_final`` writes the reference's ``<name>_state_dict.pt``,
which this package's ``cli.predict.load_variables`` and the JAX package's
``models.convert.load_torch_checkpoint`` both read. A SwinIR or HAT run's
files have the same names and layout (its state dict, ``network_swinir.py``'s
or ``hat_arch.py``'s keys); ``load_variables`` refuses them, since neither
network has a serving step.
"""

from __future__ import annotations

import json
import os
import pickle
import re

import torch

from sifsr_tpu_torch.train.early_stopping import snapshot

__all__ = ["CheckpointManager", "save_final", "load_final"]

_EPOCH_FILE = re.compile(r"^epoch_(\d+)\.pt$")


class CheckpointManager:
    """Epoch-granular checkpoints in one directory, the newest
    ``max_to_keep`` kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:06d}.pt")

    def _epochs(self) -> list[int]:
        found = (_EPOCH_FILE.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save_epoch(self, epoch: int, state, extra: dict, best_state=None) -> None:
        """Persist the train state, the best-so-far snapshot, and host-side
        bookkeeping after ``epoch``. The file appears under its name only
        once it is whole."""
        payload = {
            "model": snapshot(state.model.state_dict()),
            "optimizer": snapshot(state.optimizer.state_dict()),
            "step": state.step,
            "extra": extra,
            "best": best_state,
        }
        tmp = self._path(epoch) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(epoch))
        for old in self._epochs()[: -self.max_to_keep]:
            os.unlink(self._path(old))

    def latest_epoch(self) -> int | None:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def restore_epoch(self, epoch: int, state):
        """Restore into ``state`` (its model and optimiser, in place);
        returns (state, extra, best).

        ``best`` is the state dict of the best-so-far epoch (or None when the
        checkpoint predates any improvement snapshot)."""
        payload = torch.load(self._path(epoch), map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"], strict=True)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = payload["step"]
        return state, payload["extra"], payload["best"]

    def wait(self):
        """Saves are synchronous; kept for the JAX manager's interface."""

    def close(self):
        """Nothing is held open; kept for the JAX manager's interface."""


def save_final(save_path: str, model_name: str, state, metrics: dict, params_json: dict | None = None) -> None:
    """Final experiment persistence mirroring the reference layout
    (utils.save_model + metrics pkl + params copy,
    train_model_B_predef_filters.py:497-514):

        <save_path>/<model_name>_state_dict.pt       (the model's state dict)
        <save_path>/<model_name>_lossdata.pkl        (same dict schema)
        <save_path>/<model_name>_train_params.json
    """
    os.makedirs(save_path, exist_ok=True)
    torch.save(snapshot(state.model.state_dict()),
               os.path.join(save_path, f"{model_name}_state_dict.pt"))
    with open(os.path.join(save_path, f"{model_name}_lossdata.pkl"), "wb") as f:
        pickle.dump(metrics, f)
    if params_json is not None:
        with open(os.path.join(save_path, f"{model_name}_train_params.json"), "w") as f:
            json.dump(params_json, f, indent=1)


def load_final(save_path: str, model_name: str) -> dict:
    """The state dict saved by ``save_final`` (CPU tensors)."""
    return torch.load(os.path.join(save_path, f"{model_name}_state_dict.pt"),
                      map_location="cpu", weights_only=True)

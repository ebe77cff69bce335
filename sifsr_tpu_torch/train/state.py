"""Train state: the model (parameters and, for ModelB_2, BN statistics) and its
Adam optimiser.

Port of ``sifsr_tpu/train/state.py``. The JAX state is an immutable tree that
each step replaces; here the model and the optimiser are updated in place and
the state object only holds them together with the step count.
"""

from __future__ import annotations

import dataclasses

import torch

from sifsr_tpu_torch.device import resolve_device
from sifsr_tpu_torch.models.convert import from_jax_variables

__all__ = ["SifTrainState", "create_train_state"]


@dataclasses.dataclass
class SifTrainState:
    """Model, optimiser and the number of steps taken. The model's
    ``state_dict()`` holds live tensors (Adam and BatchNorm update them in
    place), so a snapshot of it must copy."""

    model: torch.nn.Module
    optimizer: torch.optim.Adam
    step: int = 0


def _init_parameters(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Fresh initialisation by the network's own rule, its
    ``init_parameters(generator)``: drawn on the CPU from ``generator``, so
    that a seed gives the same weights whatever device trains them."""
    model.init_parameters(generator)


def create_train_state(
    model: torch.nn.Module,
    learning_rate: float,
    generator: torch.Generator | None = None,
    variables: dict | None = None,
    device: str | torch.device = "cuda",
) -> SifTrainState:
    """Initialise ``model`` (or adopt ``variables``: its state dict, or for
    ModelB2 the JAX package's ``{'params', 'batch_stats'}`` tree), move it to
    ``device`` and attach torch-default Adam (betas 0.9/0.999, eps 1e-8: the
    rule the JAX package's optimiser copies).

    Without ``variables`` the weights are drawn from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None)."""
    dev = resolve_device(device)
    if variables is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        _init_parameters(model, generator)
    else:
        if "params" in variables:
            variables = from_jax_variables(variables)
        model.load_state_dict(variables, strict=True)
    model.to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8)
    return SifTrainState(model=model, optimizer=optimizer, step=0)

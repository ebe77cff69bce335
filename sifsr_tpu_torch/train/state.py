"""Train state: the model (parameters and BN statistics) and its Adam optimiser.

Port of ``sifsr_tpu/train/state.py``. The JAX state is an immutable tree that
each step replaces; here the model and the optimiser are updated in place and
the state object only holds them together with the step count.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from sifsr_tpu_torch.device import resolve_device
from sifsr_tpu_torch.models.convert import from_jax_variables
from sifsr_tpu_torch.models.unet import ModelB2

__all__ = ["SifTrainState", "create_train_state"]


@dataclasses.dataclass
class SifTrainState:
    """Model, optimiser and the number of steps taken. The model's
    ``state_dict()`` holds live tensors (Adam and BatchNorm update them in
    place), so a snapshot of it must copy."""

    model: ModelB2
    optimizer: torch.optim.Adam
    step: int = 0


def _init_parameters(model: ModelB2, generator: torch.Generator) -> None:
    """Fresh initialisation as the JAX model's: conv kernels, and the
    transposed convs of the ConvTranspose decoder, LeCun-normal (a normal of
    variance 1/fan_in, fan_in = input channels x kernel taps, truncated at
    two standard deviations),
    biases zero, BatchNorm scale one and shift zero, running statistics
    (0, 1). Drawn on the CPU from ``generator``, so that a seed gives the
    same weights whatever device trains them; the draws differ from JAX's."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                # 0.8796...: the standard deviation of a unit normal truncated at +-2
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                torch.nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                                            generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.reset_parameters()


def create_train_state(
    model: ModelB2,
    learning_rate: float,
    generator: torch.Generator | None = None,
    variables: dict | None = None,
    device: str | torch.device = "cuda",
) -> SifTrainState:
    """Initialise ``model`` (or adopt ``variables``: a ModelB2 state dict, or
    the JAX package's ``{'params', 'batch_stats'}`` tree), move it to
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

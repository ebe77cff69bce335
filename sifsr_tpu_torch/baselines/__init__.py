"""Classical LST-sharpening baselines (host-side numpy).

Port of ``sifsr_tpu/baselines``: for now the bicubic floor method of the
evaluation; TsHARP, ATPRK, AATPRK and the Data-Mining Sharpener are
ROADMAP.md §1 item 2.
"""

from sifsr_tpu_torch.baselines.bicubic import bicubic_sr

__all__ = ["bicubic_sr"]

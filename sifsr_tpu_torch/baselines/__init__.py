"""Classical LST-sharpening baselines.

Port of ``sifsr_tpu/baselines``: the comparison set of the reference's
evaluation (SURVEY.md §2 #25-28). Bicubic, TsHARP, ATPRK and AATPRK are
host numpy and scipy, as in the JAX package; the Data-Mining Sharpener fits
and applies its bagged regression trees in torch on a device
(``baselines.forest``), where the JAX package calls scikit-learn.
"""

from sifsr_tpu_torch.baselines.bicubic import bicubic_sr
from sifsr_tpu_torch.baselines.tsharp import tsharp
from sifsr_tpu_torch.baselines.atprk import atprk
from sifsr_tpu_torch.baselines.aatprk import aatprk
from sifsr_tpu_torch.baselines.dms import DecisionTreeSharpener, dms_sharpen

__all__ = ["bicubic_sr", "tsharp", "atprk", "aatprk", "DecisionTreeSharpener", "dms_sharpen"]

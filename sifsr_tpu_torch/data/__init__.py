from sifsr_tpu_torch.data.statistics import Statistics

__all__ = ["Statistics"]

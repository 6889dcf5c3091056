"""The port's training data: the reference's synthetic pipeline, copied."""
from repro_torch.data.pipeline import DataConfig, batches, make_batch, to_device

__all__ = ["DataConfig", "batches", "make_batch", "to_device"]

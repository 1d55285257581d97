from repro_torch.data.pipeline import DataConfig, batch_at, stream

__all__ = ["DataConfig", "batch_at", "stream"]

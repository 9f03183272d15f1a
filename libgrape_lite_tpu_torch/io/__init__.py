"""Graph file parsing."""
from libgrape_lite_tpu_torch.io.io_adaptor import LocalIOAdaptor

__all__ = ["LocalIOAdaptor"]

from vqwild_tpu_torch.core.device import disable_tf32, resolve_device
from vqwild_tpu_torch.core.logging import get_logger

__all__ = ["disable_tf32", "get_logger", "resolve_device"]

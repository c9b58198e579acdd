"""The port's LM stack (the dense decoder kind of ``repro.models``)."""
from repro_torch.models import attention, common, registry, transformer

__all__ = ["attention", "common", "registry", "transformer"]

from repro_torch.core.api import find_bridges

__all__ = ["find_bridges"]

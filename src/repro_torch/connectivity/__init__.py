from repro_torch.connectivity.common import tour_state
from repro_torch.connectivity.device import bridge_mask, bridges

__all__ = ["bridge_mask", "bridges", "tour_state"]

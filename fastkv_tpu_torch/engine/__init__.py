"""engine layer of the PyTorch port (see the package docstring)."""

from fastkv_tpu_torch.engine.dispatch import Coordinator, serve_worker
from fastkv_tpu_torch.engine.serve import FrontDoor, init_distributed, local_front_door

__all__ = ["Coordinator", "FrontDoor", "init_distributed", "local_front_door", "serve_worker"]

from agile3d_torch.interactive.dataloader import InteractiveDataLoader
from agile3d_torch.interactive.server import InteractiveSegmentationServer

__all__ = ["InteractiveDataLoader", "InteractiveSegmentationServer"]

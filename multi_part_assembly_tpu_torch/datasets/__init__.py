"""Dataset dispatch (JAX datasets/__init__.py: `build_dataloader`)."""

from .geometry import (DataLoader, GeometryPartDataset, augment_geometry_batch,
                       build_geometry_dataloader)
from .mesh_io import MeshSampler
from .partnet import PartNetPartDataset, build_partnet_dataloader

__all__ = ['build_dataloader', 'DataLoader', 'GeometryPartDataset',
           'PartNetPartDataset', 'MeshSampler', 'augment_geometry_batch',
           'build_geometry_dataloader', 'build_partnet_dataloader']


def build_dataloader(cfg):
    """Train and val loaders of `cfg.data.dataset`."""
    if cfg.data.dataset == 'partnet':
        return build_partnet_dataloader(cfg)
    if cfg.data.dataset == 'geometry':
        return build_geometry_dataloader(cfg)
    raise NotImplementedError(f'dataset {cfg.data.dataset} is not supported')

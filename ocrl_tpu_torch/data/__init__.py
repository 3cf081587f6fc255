"""Datasets of the port (counterpart of ocrl_tpu/data): the HDF5 subset
the collectors write (``hdf5_format``, no h5py), the memmapped loader with
its chunk shuffle (``hdf5``), the prefetch to the card (``prefetch``) and
the collector of the synthetic envs (``collect``)."""

from .hdf5 import DataLoader, H5Dataset, get_dataloaders, resolve_datafile
from .prefetch import prefetch_to_device

__all__ = ["DataLoader", "H5Dataset", "get_dataloaders", "prefetch_to_device",
           "resolve_datafile"]

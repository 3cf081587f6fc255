"""Datasets of the port (counterpart of ocrl_tpu/data): HDF5 read in every
layout h5py writes and written as the collectors write it (``hdf5_format``,
no h5py), the loader with its chunk shuffle, memmapped or assembled from
decoded chunks (``hdf5``), the prefetch to the card (``prefetch``) and the
collector of the synthetic envs (``collect``)."""

from .hdf5 import DataLoader, H5Dataset, get_dataloaders, resolve_datafile
from .prefetch import prefetch_to_device

__all__ = ["DataLoader", "H5Dataset", "get_dataloaders", "prefetch_to_device",
           "resolve_datafile"]

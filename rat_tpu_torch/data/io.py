"""Artifact IO (port of rat_tpu.data.io).

The port writes its encoded splits as ``.npy`` and their retrieval
caches as ``.npz``, with numpy alone; ``.h5`` files (the JAX package's
splits and caches, pretrained tables) are read and written through
h5py, imported inside the functions that touch them. Every write goes
to a temporary sibling first and is renamed into place, so a crash
never leaves a partial artifact that a later existence check would
trust.
"""

import logging
import os

import numpy as np


def _atomic_write(data_path, write):
    parent = os.path.dirname(data_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp_path = data_path + ".tmp.%d" % os.getpid()
    try:
        write(tmp_path)
        os.replace(tmp_path, data_path)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)


def save_npy_atomic(array, data_path):
    logging.info("Saving data to npy: %s", data_path)

    def write(tmp):
        with open(tmp, "wb") as fh:   # a file object: np.save adds no suffix
            np.save(fh, array)
    _atomic_write(data_path, write)


def save_npz_atomic(arrays, data_path):
    """Several arrays (a dict of key -> array) as ONE .npz file."""
    logging.info("Saving data to npz: %s", data_path)

    def write(tmp):
        with open(tmp, "wb") as fh:   # a file object: no second ".npz"
            np.savez(fh, **arrays)
    _atomic_write(data_path, write)


def save_hdf5(data_array, data_path, key="data"):
    """Append one dataset under ``key`` to the h5 file ``data_path``
    (created, with its parent directories, when missing), as the JAX
    package's save_hdf5 does."""
    import h5py
    logging.info("Saving data to h5: %s", data_path)
    parent = os.path.dirname(data_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with h5py.File(data_path, "a") as hf:
        hf.create_dataset(key, data=data_array)


def save_hdf5_atomic(datasets, data_path):
    """Write several datasets (a dict of key -> array) as ONE h5 file,
    atomically."""
    import h5py
    logging.info("Saving data to h5: %s", data_path)

    def write(tmp):
        with h5py.File(tmp, "w") as hf:
            for key, arr in datasets.items():
                hf.create_dataset(key, data=arr)
    _atomic_write(data_path, write)


def load_hdf5(data_path, key=None, verbose=True):
    import h5py
    if verbose:
        logging.info("Loading data from h5: " + data_path)
    with h5py.File(data_path, "r") as hf:
        if key is not None:
            data_array = hf[key][()]
        else:
            data_array = hf[list(hf.keys())[0]][()]
    return data_array


def load_array(data_path, key=None):
    """One array by the file's suffix: ``.npy``, ``.npz`` (array ``key``)
    or ``.h5`` (dataset ``key``, or its first)."""
    if data_path.endswith(".h5"):
        return load_hdf5(data_path, key)
    logging.info("Loading data from: " + data_path)
    if data_path.endswith(".npy"):
        return np.load(data_path)
    if data_path.endswith(".npz"):
        with np.load(data_path) as npz:
            return npz[key]
    raise ValueError("unknown array file type: {}".format(data_path))


def load_arrays(data_path):
    """Every array of an ``.npz`` or ``.h5`` file, as a dict by key."""
    if data_path.endswith(".h5"):
        import h5py
        with h5py.File(data_path, "r") as hf:
            return {key: hf[key][()] for key in hf.keys()}
    with np.load(data_path) as npz:
        return {key: npz[key] for key in npz.files}


def array_rows(data_path):
    """Row count of a ``.npy`` or ``.h5`` split without reading it."""
    if data_path.endswith(".h5"):
        import h5py
        with h5py.File(data_path, "r") as hf:
            return hf[list(hf.keys())[0]].shape[0]
    return np.load(data_path, mmap_mode="r").shape[0]

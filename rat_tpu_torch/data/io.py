"""HDF5 artifact IO (port of rat_tpu.data.io). h5py is imported inside
each function, so the scoring path imports without it."""

import logging
import os


def save_hdf5_atomic(datasets, data_path):
    """Write several datasets (a dict of key -> array) as ONE h5 file,
    atomically: written to a temporary sibling and renamed into place,
    so a crash never leaves a partial cache behind."""
    import h5py
    logging.info("Saving data to h5: %s", data_path)
    parent = os.path.dirname(data_path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp_path = data_path + ".tmp.%d" % os.getpid()
    try:
        with h5py.File(tmp_path, "w") as hf:
            for key, arr in datasets.items():
                hf.create_dataset(key, data=arr)
        os.rename(tmp_path, data_path)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)


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

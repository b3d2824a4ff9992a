from .io import load_array, load_hdf5, save_hdf5
from .build import build_dataset, split_train_test
from .loader import DataGenerator, get_data_generator, h5_generator
from .block_loader import DataBlockGenerator

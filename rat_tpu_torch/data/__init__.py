from .io import load_array
from .build import build_dataset, split_train_test
from .loader import DataGenerator, h5_generator

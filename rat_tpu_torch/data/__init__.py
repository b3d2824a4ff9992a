from .loader import DataGenerator, h5_generator

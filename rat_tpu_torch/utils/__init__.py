from .config import (Monitor, load_config, load_dataset_config, print_to_json,
                     print_to_list, set_logger)
from .device import resolve_device
from .seeding import seed_everything

from .optim import get_optimizer, get_regularizer
from .trainer import Trainer

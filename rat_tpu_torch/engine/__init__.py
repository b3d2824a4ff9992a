from .trainer import Trainer

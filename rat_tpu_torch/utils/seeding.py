"""Determinism helpers (port of rat_tpu.utils.seeding)."""

import os
import random

import numpy as np
import torch


def seed_everything(seed=1029):
    """Seed every RNG the pipeline can touch: Python, numpy and torch
    (CPU and every CUDA device)."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

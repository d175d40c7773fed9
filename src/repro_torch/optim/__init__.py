"""Optimizers (the port's copy of `repro/optim/optimizers.py`)."""
from .optimizers import (Optimizer, adam, get_optimizer, lamb, momentum,
                         sgd)

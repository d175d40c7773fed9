"""Optimizers, LR schedules and the dynamic loss scaler (the port's
copies of `repro/optim/`)."""
from .optimizers import (Optimizer, adam, get_optimizer, lamb, momentum,
                         sgd)
from .scaling import DynamicLossScaler, ScalerState
from .schedules import get_schedule

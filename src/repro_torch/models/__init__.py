"""Dense GQA decoder (slice 1 of the port of `repro.models`)."""
from .api import Model, build_model, count_params

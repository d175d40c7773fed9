"""The decoders, the SSM mixers and the encoder-decoder (the port of
`repro.models`)."""
from .api import Model, build_model, count_params

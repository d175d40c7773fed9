"""Hand-written CUDA kernels of the port (`flash_attention`), their
build and launch counters (`build`)."""

"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (`grid_solve.py`), built on first use by `build.py`."""

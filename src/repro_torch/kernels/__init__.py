"""Hand-written Hopper kernels of the port (one subpackage per TPU kernel)."""

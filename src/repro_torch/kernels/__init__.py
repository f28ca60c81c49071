"""The port's kernels (CUDA sources in ``csrc``): hierarchization and flash
attention, each beside its plain version."""

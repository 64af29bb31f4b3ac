"""Device operations: staging, the solver and its kernels, the pipeline."""

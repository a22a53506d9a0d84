"""Plain PyTorch references of the benchmark's configurations: float32
arithmetic, no kernels, no cache manager, no batching tricks.  Nothing
here imports the program under test."""

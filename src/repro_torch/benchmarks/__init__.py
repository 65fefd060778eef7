"""The port's benchmarks: ``python -m repro_torch.benchmarks.kernel_bench``."""

from deepmerge_tpu_torch.utils.profiling import phase_timer, Timings  # noqa: F401

"""Host-side utilities: input padding, tensors to numpy, experiment
tracking and artifacts, profiling."""

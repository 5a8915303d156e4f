"""Command-line tools of the port, run as ``python -m
repro_torch.tools.<name>``: ``fit_learned_model`` records a profile and
fits the learned latency model."""

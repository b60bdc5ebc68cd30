"""Probes of the port's kernels on the card: scripts that build variants of
a kernel source and time them, run as ``python -m
rla4mor_tpu_torch.probes.<name>``. Importing them does nothing."""

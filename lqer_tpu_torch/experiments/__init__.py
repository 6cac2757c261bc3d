"""Counterparts of the JAX package's ``experiments/`` entry points, each run as
``python -m lqer_tpu_torch.experiments.<name>``."""

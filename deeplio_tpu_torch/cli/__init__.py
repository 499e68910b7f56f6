"""Command-line entry points: ``python -m deeplio_tpu_torch.cli.train``,
``.test``, ``.stream`` and ``.export`` (the JAX package's flags; each
takes ``--device cuda|cpu``, CUDA by default)."""

"""Command-line entry points: ``python -m deeplio_tpu_torch.cli.train``,
``.test``, ``.stream``, ``.export`` and ``.pretrain_pointseg`` (the JAX
package's flags; each takes ``--device cuda|cpu``, CUDA by default)."""

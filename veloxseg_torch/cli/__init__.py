"""Command-line entry points: ``python -m veloxseg_torch.cli.test_main``
(whole-volume inference over NIfTI volumes)."""

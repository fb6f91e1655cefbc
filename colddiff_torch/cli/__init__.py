"""The command line: ``python -m colddiff_torch.cli.main train|test ...``
and the SLURM job-array launcher ``python -m colddiff_torch.cli.dispatch``."""

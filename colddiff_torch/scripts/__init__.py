"""Entry points run with ``python -m colddiff_torch.scripts.<name>``."""

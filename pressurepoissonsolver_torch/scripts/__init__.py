"""Command-line measurement scripts of the port (``python -m
pressurepoissonsolver_torch.scripts.<name>``)."""

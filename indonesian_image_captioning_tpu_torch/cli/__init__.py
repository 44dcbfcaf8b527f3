"""Command-line entry points (run as ``python -m ...cli.<name>``)."""

"""Command-line tools of the port (``python -m ...tools.<name>``)."""

"""Command-line tools of the port (run on a card)."""

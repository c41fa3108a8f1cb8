"""Command-line entry point."""

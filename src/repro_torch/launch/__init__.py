"""The port's command-line launchers."""

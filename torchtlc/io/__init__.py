"""The TLC transcript of the port's `check` command."""

"""Config overrides, the CLI, metrics logging and weight conversion."""

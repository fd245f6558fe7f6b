"""Config overrides and weight conversion."""

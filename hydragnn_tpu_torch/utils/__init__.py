"""Config loading and data-driven config completion."""

"""The new-project wizard."""

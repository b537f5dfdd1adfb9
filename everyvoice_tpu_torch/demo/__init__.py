"""The interactive synthesis demo server."""

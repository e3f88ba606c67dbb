"""Port-side tools (twins of the reference's ``tools/``)."""

"""Host-side utilities: input padding."""

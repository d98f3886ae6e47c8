"""Host cryptography the port carries for itself (pure Python)."""

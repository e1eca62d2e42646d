"""Host-side planning for the windowed-gather expand (numpy)."""

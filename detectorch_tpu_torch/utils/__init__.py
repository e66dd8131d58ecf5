"""Host utilities: training statistics and timers."""

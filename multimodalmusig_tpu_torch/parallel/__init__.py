"""Best-of-N restart fitting with restarts as a leading tensor dimension."""

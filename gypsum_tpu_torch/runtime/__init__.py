"""The receiver block loop and its host-side pieces."""

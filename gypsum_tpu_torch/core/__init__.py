"""Shared vocabulary: device selection, constants, configuration tree, events."""

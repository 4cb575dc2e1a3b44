"""Tracking: the two-phase block tracker and the channel bank."""

"""Batched cold-start satellite acquisition."""

"""Artifact schema of the port."""

"""Executable entry points of the port (the launch/*.launch analogues)."""

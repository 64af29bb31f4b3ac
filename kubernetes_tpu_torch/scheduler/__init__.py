"""Scheduler entry points."""

"""Optimizer schedules."""

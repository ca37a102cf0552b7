"""Utilities: the package logger and the serving transfer counters."""

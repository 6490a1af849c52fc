"""Serving: the continuous-batching decode pool and its futures."""

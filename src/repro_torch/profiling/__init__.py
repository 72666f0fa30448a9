"""Workload characteristics of the served models."""

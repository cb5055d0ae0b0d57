"""Measurement helpers."""

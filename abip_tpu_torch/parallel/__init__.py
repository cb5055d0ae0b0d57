"""Batched solvers: many instances, one lane each, solved together."""

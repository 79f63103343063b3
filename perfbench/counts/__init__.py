"""Frozen operation and byte counts: the model FLOPs of a training step of
each family, and each kernel's operations and bytes from a call's shapes."""

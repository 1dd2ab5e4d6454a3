"""Seeding, device selection, PNG writers and the throughput counter."""

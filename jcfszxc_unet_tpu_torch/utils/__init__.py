"""Seeding, device selection and PNG writers."""

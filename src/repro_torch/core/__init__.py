"""Pooling, PLAID index and search for the port."""

"""Pieces of the JAX trainer that the serving slice needs."""
